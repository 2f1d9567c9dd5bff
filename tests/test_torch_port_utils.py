"""PyTorch port (simseg_tpu_torch): the utils modules and the public API
against the JAX package's (``simseg_tpu/utils/{registry,context,logger,
misc}.py``, ``simseg_tpu/__init__.py``).

- ``Registry``: the decorator forms, the errors on a duplicate and an
  unknown name (JAX's messages), ``build_from_cfg``; the port's four tables
  hold JAX's names; an op a user registers in ``TRANSFORMS`` is found by
  both of the port's pipelines.
- ``split_list_evenly`` and ``AverageMeter`` equal to JAX's on the same
  inputs; ``to_list``.
- ``download`` / ``download_to_local_file`` against an ``http.server`` on
  127.0.0.1 in this process: a retry after one failed response, the
  failure after ``retry`` of them.
- ``ENV`` without a world; the logger's EMPH level, caller prefix and file
  sink; the lazy public API loads no submodule on import.
"""

import http.server
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from simseg_tpu.utils import misc as jax_misc
from simseg_tpu.utils import registry as jax_registry
from simseg_tpu_torch.utils import misc
from simseg_tpu_torch.utils.context import ENV, local_root_only, root_only
from simseg_tpu_torch.utils.registry import Registry, build_from_cfg

torch.set_num_threads(1)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_registry_forms_and_errors(package):
    Reg = Registry if package == "port" else jax_registry.Registry
    build = build_from_cfg if package == "port" else jax_registry.build_from_cfg
    reg = Reg("THINGS")

    @reg.register
    def plain(cfg, scale=1):
        return cfg * scale

    @reg.register(name="alias")
    def other(cfg):
        return -cfg

    reg.register_obj(lambda cfg: cfg + 1, name="lam")
    assert reg.name == "THINGS" and "plain" in reg and "other" not in reg
    assert sorted(reg.keys()) == ["alias", "lam", "plain"]
    assert build("plain", 3, reg, scale=2) == 6 and build("alias", 3, reg) == -3
    with pytest.raises(KeyError, match="'plain' already registered in THINGS"):
        reg.register(plain)
    with pytest.raises(KeyError, match="'nope' is not registered in THINGS; "
                                       r"available: \['alias', 'lam', 'plain'\]"):
        reg.get("nope")


def test_the_tables_hold_jaxs_names():
    from simseg_tpu.core.lr_schedule import LR as jax_lr
    from simseg_tpu.data.datasets import DATALOADER as jax_loaders
    from simseg_tpu.data.transforms import TRANSFORMS as jax_transforms
    from simseg_tpu.models.clip import PIPELINE as jax_pipeline
    import simseg_tpu.models.linear_prob  # noqa: F401  (registers linear_prob)
    from simseg_tpu_torch.core.lr_schedule import LR
    from simseg_tpu_torch.data.datasets import DATALOADER
    from simseg_tpu_torch.data.transforms import TRANSFORMS
    import simseg_tpu_torch.data.train_transforms  # noqa: F401  (the train ops)
    from simseg_tpu_torch.models.clip import PIPELINE
    import simseg_tpu_torch.models.linear_prob  # noqa: F401

    assert sorted(LR) == sorted(jax_lr)
    assert sorted(DATALOADER) == sorted(jax_loaders)
    assert sorted(PIPELINE) == sorted(jax_pipeline)
    assert sorted(TRANSFORMS) == sorted(jax_transforms)


def test_a_user_transform_reaches_both_pipelines():
    from PIL import ImageOps

    from simseg_tpu_torch.config import new_base_cfg, update_cfg
    from simseg_tpu_torch.data.transforms import TRANSFORMS, build_transforms
    from simseg_tpu_torch.tasks.clip.config import task_cfg_init_fn

    name = "test_user_invert"

    @TRANSFORMS.register(name=name)
    def invert(cfg):
        return ImageOps.invert

    try:
        cfg = update_cfg(task_cfg_init_fn, None,
                         [f"transforms.train_transforms=[{name}]",
                          f"transforms.valid_transforms=[{name}]"],
                         target=new_base_cfg())
        img = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (6, 9, 3), dtype=np.uint8))
        for mode in ("train", "valid"):
            out = build_transforms(cfg, mode)(img)
            np.testing.assert_array_equal(np.asarray(out), 255 - img.numpy())
        with pytest.raises(KeyError, match="already registered"):
            TRANSFORMS.register(lambda cfg: None, name="resize")
    finally:
        TRANSFORMS._objs.pop(name)


@pytest.mark.parametrize("n_items,parts", [(0, 3), (7, 3), (10, 4), (5, 5),
                                           (3, 5), (12, 1)])
def test_split_list_evenly_matches_jax(n_items, parts):
    items = list(range(n_items))
    assert misc.split_list_evenly(items, parts) == jax_misc.split_list_evenly(
        items, parts)


def test_average_meter_and_to_list_match_jax():
    ours, theirs = misc.AverageMeter("loss", ":.3f"), jax_misc.AverageMeter(
        "loss", ":.3f")
    rng = np.random.default_rng(3)
    for v, n in zip(rng.normal(size=9), rng.integers(1, 5, 9)):
        ours.update(v, int(n))
        theirs.update(v, int(n))
        assert (ours.val, ours.sum, ours.count, ours.avg) == (
            theirs.val, theirs.sum, theirs.count, theirs.avg)
        assert str(ours) == str(theirs)
    ours.reset()
    assert (ours.val, ours.avg, ours.sum, ours.count) == (0.0, 0.0, 0.0, 0)
    for x in (3, [1, 2], (4,), "ab"):
        assert misc.to_list(x) == jax_misc.to_list(x)


class _Flaky(http.server.BaseHTTPRequestHandler):
    """Fails the first ``fail`` requests with 503, then serves ``body``."""
    fail = 1
    body = b"payload bytes"
    seen = 0

    def do_GET(self):
        type(self).seen += 1
        if type(self).seen <= type(self).fail:
            self.send_response(503)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(self.body)))
        self.end_headers()
        self.wfile.write(self.body)

    def log_message(self, *args):
        pass


@pytest.fixture
def server():
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Flaky)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    _Flaky.seen = 0
    yield f"http://127.0.0.1:{srv.server_address[1]}/file.bin"
    srv.shutdown()
    srv.server_close()


def test_download_retries_after_a_failed_response(server, tmp_path):
    _Flaky.fail = 1
    assert misc.download(server, timeout=5, retry=3) == _Flaky.body
    assert _Flaky.seen == 2
    _Flaky.seen = 0
    path = tmp_path / "f.bin"
    misc.download_to_local_file(server, str(path), timeout=5, retry=2)
    assert path.read_bytes() == _Flaky.body
    _Flaky.seen, _Flaky.fail = 0, 5
    with pytest.raises(RuntimeError, match="download .* failed"):
        misc.download(server, timeout=5, retry=2)
    assert _Flaky.seen == 2
    _Flaky.seen = 0
    # JAX's on the same server, for the same behaviour
    _Flaky.fail = 1
    assert jax_misc.download(server, timeout=5, retry=3) == _Flaky.body
    assert _Flaky.seen == 2


def test_context_without_a_world():
    assert (ENV.rank, ENV.size, ENV.is_root, ENV.local_rank) == (0, 1, True, 0)
    assert ENV.device == torch.device("cuda", 0)
    if not torch.cuda.is_available():
        assert ENV.devices == [] and ENV.device_count == 0
    assert root_only(lambda: 7)() == 7 and local_root_only(lambda: 8)() == 8


def test_logger_levels_prefix_and_file(tmp_path, capsys):
    from simseg_tpu_torch.utils.logger import EMPH, logger

    logger.set_file(str(tmp_path / "log.txt"))
    logger.emph("emphasised", 3)
    logger.debug("hidden")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "[EMPH][test_torch_port_utils.py:" in line and line.endswith(
        "emphasised 3")
    assert "emphasised 3" in (tmp_path / "log.txt").read_text()
    assert EMPH == 25 and logger.level == 20
    with pytest.raises(SystemExit):
        logger.fatal("stop")


def test_the_public_api_is_lazy():
    code = ("import sys, simseg_tpu_torch as s\n"
            "assert not [m for m in sys.modules if m.startswith('simseg_tpu_torch.')]\n"
            "assert 'jax' not in sys.modules\n"
            "names = sorted(s._PUBLIC)\n"
            "objs = [getattr(s, n) for n in names]\n"
            "assert 'jax' not in sys.modules and 'simseg_tpu' not in sys.modules\n"
            "print(','.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(_repo()))
    assert out.returncode == 0, out.stderr[-2000:]
    import simseg_tpu

    want = set(simseg_tpu._PUBLIC) - {"TrainState"}
    assert set(out.stdout.strip().split(",")) == want


def _repo():
    import pathlib

    return pathlib.Path(__file__).resolve().parents[1]
