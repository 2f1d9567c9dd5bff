"""PyTorch port (simseg_tpu_torch): the hand-written kernels' entry points
as registered custom ops (``simseg::``), on the CPU, where each op runs its
plain version.

- ``torch.library.opcheck`` of every op (schema, fake tensor, autograd
  registration, AOT dispatch with dynamic shapes) at small shapes;
- each op's fake output equal in shape, dtype and stride to its CPU
  output;
- an exported seg graph (the tiny CLIP at 32 px) holds the CRF op, or the
  tail op, exactly once;
- the launch counters count launches on the card only: CPU calls leave
  them as they were.

The CUDA implementations are held by ``tests/test_torch_port_kernels.py``
(marker ``cuda``).
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from simseg_tpu_torch import serving
from simseg_tpu_torch.models.clip import CLIPModel
from simseg_tpu_torch.ops import crf_fused, crf_pallas, flash_attention
from simseg_tpu_torch.utils.collections import AttrDict

torch.set_num_threads(1)


def _crf_args(seed=0, b=2, k=3, h=16, w=24):
    g = torch.Generator().manual_seed(seed)
    du = torch.randn((b, k, h, w), generator=g) * 3
    rgb = torch.randint(0, 256, (b, h, w, 3), generator=g, dtype=torch.uint8)
    return (du, rgb, 2, 3.0, 3.0, 40.0, 13.0, 10.0, 4, 7)


def _tail_args(seed=1, b=2, k=3, grid=4, factor=4):
    g = torch.Generator().manual_seed(seed)
    du = torch.randn((b, k, grid, grid), generator=g) * 3
    rgb = torch.randint(0, 256, (b, grid * factor, grid * factor, 3),
                        generator=g, dtype=torch.uint8)
    scores = torch.rand((b, k), generator=g)
    cand = torch.randint(1, 20, (b, k), generator=g)
    return (du, rgb, scores, cand, factor, 2, 3.0, 3.0, 40.0, 13.0, 10.0, 4, 7)


def _matvec_args(seed=2, b=2, n=40, f=5, c=3):
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn((b, n, f), generator=g)
    q = torch.randn((b, c, n), generator=g).transpose(1, 2)  # a strided view
    return (feat, q)


def _qkv(seed=3, b=2, t=20, h=2, hd=64, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return tuple((torch.randn((b, t, h, hd), generator=g) * s).to(dtype)
                 for s in (0.125, 1.0, 1.0))


def _bwd_args():
    q, k, v = _qkv()
    out, lse = flash_attention.flash_attention_fwd(q, k, v, True, "train")
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)
                    ).to(q.dtype)
    return (q, k, v, out, g, lse)


CASES = {
    "crf_mean_field": (crf_fused.crf_mean_field, _crf_args),
    "crf_decode_tail": (crf_fused.crf_decode_tail, _tail_args),
    "bilateral_matvec": (crf_pallas.bilateral_matvec_op, _matvec_args),
    "flash_attention_fwd": (flash_attention.flash_attention_fwd,
                            lambda: _qkv() + (False, "flash")),
    "flash_attention_fwd_lse_stream": (flash_attention.flash_attention_fwd,
                                       lambda: _qkv() + (True, "stream")),
    "flash_attention_bwd": (flash_attention.flash_attention_bwd, _bwd_args),
}


@pytest.mark.parametrize("name", list(CASES))
def test_opcheck_cpu_implementation(name):
    op, make = CASES[name]
    torch.library.opcheck(op, make())


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", list(CASES))
def test_fake_output_is_the_cpu_output_layout(name):
    op, make = CASES[name]
    args = make()
    real = _outputs(op(*args))
    with FakeTensorMode() as mode:
        fake_args = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                          else a for a in args)
        fake = _outputs(op(*fake_args))
    assert len(fake) == len(real)
    for f, r in zip(fake, real):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype, r.stride())


def test_ops_run_the_plain_versions_on_the_cpu():
    """The CPU implementations are the wrappers' plain versions: bit-equal
    to them, and no launch counted."""
    before = {m: (m.LAUNCHES, getattr(m, "TAIL_LAUNCHES", 0))
              for m in (crf_fused, crf_pallas, flash_attention)}
    bwd, lanes = flash_attention.BWD_LAUNCHES, dict(flash_attention.LANE_CALLS)
    du, rgb, iters, *_ = _crf_args()
    assert torch.equal(crf_fused.crf_mean_field(*_crf_args()),
                       crf_fused.mean_field_fused_plain(
                           du, rgb, num_iters=iters, stride=4, closing_ksize=7))
    targs = _tail_args()
    got = crf_fused.crf_decode_tail(*targs)
    want = crf_fused.seg_decode_tail_fused_plain(
        *targs[:5], num_iters=2, stride=4, closing_ksize=7)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    feat, q = _matvec_args()
    assert torch.equal(crf_pallas.bilateral_matvec_op(feat, q),
                       crf_pallas.bilateral_matvec_plain(feat, q))
    q3 = _qkv()
    out, lse = flash_attention.flash_attention_fwd(*q3, True, "stream")
    want_out, want_lse = flash_attention.flash_mha_stream_plain(*q3, with_lse=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    out, empty = flash_attention.flash_attention_fwd(*q3, False, "flash")
    assert torch.equal(out, flash_attention.flash_mha_plain(*q3))
    assert empty.shape == (0,)
    bargs = _bwd_args()
    got = flash_attention.flash_attention_bwd(*bargs)
    want = flash_attention.flash_mha_long_bwd_plain(*bargs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert before == {m: (m.LAUNCHES, getattr(m, "TAIL_LAUNCHES", 0))
                      for m in (crf_fused, crf_pallas, flash_attention)}
    assert (flash_attention.BWD_LAUNCHES, flash_attention.LANE_CALLS) == (bwd, lanes)


def test_attention_forward_op_refuses_an_unknown_lane():
    with pytest.raises(ValueError, match="lane"):
        flash_attention.flash_attention_fwd(*_qkv(), False, "other")


@pytest.mark.parametrize("crf_backend,op", [
    ("auto", torch.ops.simseg.crf_mean_field.default),
    ("fused_tail", torch.ops.simseg.crf_decode_tail.default),
])
def test_exported_seg_graph_calls_the_crf_op_once(tmp_path, monkeypatch,
                                                  crf_backend, op):
    """The seg pipeline staged on the CPU holds the CRF kernel's op once
    (the kernel lane of the decode, whose CPU implementation is the plain
    version), and no other of the port's ops; the loaded graph calls it
    once a call."""
    torch.manual_seed(0)
    model = CLIPModel(image_tag="vit_test", img_size=32, text_tag="bert_test",
                      projection_dim=16, image_k=3)
    cfg = AttrDict()
    cfg.transforms = AttrDict(input_size=32, normalize=AttrDict(
        mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225]))
    cfg.seg_eval = AttrDict(crf_backend=crf_backend)
    rng = np.random.default_rng(0)
    fn = serving.make_seg_infer_fn(
        model, torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32)),
        cfg, num_classes=5, top_cls_num=3, device="cpu")
    x = torch.from_numpy(rng.integers(0, 255, (2, 32, 32, 3)).astype(np.uint8))
    path = str(tmp_path / "seg.pt2")
    serving.save_artifact(path, serving.export_artifact(fn, (x,)))
    graph = torch.export.load(path).graph
    ours = [n.target for n in graph.nodes
            if n.op == "call_function" and str(n.target).startswith("simseg.")]
    assert ours == [op]
    calls = []
    impl = (crf_fused.mean_field_fused_plain if crf_backend == "auto"
            else crf_fused.seg_decode_tail_fused_plain)
    name = impl.__name__

    def counted(*a, **k):
        calls.append(1)
        return impl(*a, **k)

    loaded = serving.load_artifact(path)
    monkeypatch.setattr(crf_fused, name, counted)
    loaded(x)
    loaded(x)
    assert len(calls) == 2


class _Attention(torch.nn.Module):
    def forward(self, q, k, v):
        return flash_attention.flash_mha(q, k, v) * 2


def test_exported_attention_stages_the_forward_op(tmp_path):
    """``flash_mha``'s autograd Function, staged without gradients, leaves
    the forward op in the graph (whole-T lane, no lse), which the loaded
    graph runs as the live call does."""
    q, k, v = _qkv()
    with torch.no_grad():
        program = torch.export.export(_Attention(), (q, k, v), strict=False)
    ours = [(n.target, n.args[3:]) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("simseg.")]
    assert ours == [(torch.ops.simseg.flash_attention_fwd.default,
                     (False, "flash"))]
    path = str(tmp_path / "attn.pt2")
    torch.export.save(program, path)
    with torch.no_grad():
        assert torch.equal(torch.export.load(path).module()(q, k, v),
                           _Attention()(q, k, v))
