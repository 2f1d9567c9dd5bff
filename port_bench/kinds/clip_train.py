"""CLIP pretraining steps as the runner takes them (``core/runner.py``,
``CLIPRunner.batch_processor``).

Set-up builds one training object: the model (``build_clip_model`` on the
configuration, the seeded weights), the optimizer (``build_optimizer``),
the schedule (``build_schedule`` over the traffic's total steps) and the
step (``make_train_step`` with the runner's arguments). It then drives that
object through its first steps with the window's own call and feed, on
distinct batches of the pool: in the first step it reads the embeddings
the model hands to the loss, after it the gradient AdamW received (its
first moment over 1 - beta1), after each of the first three the loss,
after the third the change of every tensor; a fourth step finishes the
warm-up. The window goes on with the same object, at the
steps after those, reading the loss back every ``log_interval`` steps as
the runner's logger does, and synchronising once at its end.

After the window the reference takes the same three steps from the same
seeded weights and batches; the numbers read are the loss gaps, the first
step's embedding gaps and, by the worst tensor and by the median tensor,
the gaps of the first gradient's norm and of the change's norm after three
steps, each against the reference's norm of that tensor or the median
tensor's, whichever is larger; the cell's limits file names those
compared. Tensor elements whose reference gradient stays under a
thousandth of the median tensor's root-mean-square first gradient in all
three steps move by round-off alone under Adam (a key's bias under
softmax, inside the fused qkv bias too): they are left out of the change.
With a ``variant`` (``CONTROLS``) the reference with a lower precision's
roundings takes the program's place and is judged by the same checks.
"""

from __future__ import annotations

import math
import statistics
import time

import torch
from torch.profiler import record_function

from pbench import data, program
from pbench_ref import FP8Hybrid, precise
from pbench_ref import train as ref_train
from pbench_ref.clip import Ref

FOLLOWED = 3  # the steps the reference follows
CONTROLS = {"fp8": FP8Hybrid()}  # the control: fp8 training's hybrid recipe


def _opt_param(ctx):
    return ctx.config["program"]["optim"]


def setup(ctx) -> None:
    from simseg_tpu_torch.core.lr_schedule import build_schedule
    from simseg_tpu_torch.core.optim import build_optimizer
    from simseg_tpu_torch.data.transforms import normalize_images
    from simseg_tpu_torch.engine.train_step import make_train_step

    t, dev = ctx.traffic, ctx.device
    cfg = program.config_tree(ctx.config, [])
    model = program.model(ctx, cfg, program.state(ctx)).train()
    optimizer = build_optimizer(cfg, model)
    schedule = build_schedule(cfg, int(t["total_steps"]))
    step_fn = make_train_step(
        model, optimizer, smoothing=cfg.loss.get("smoothing", 0.0),
        loss_name=cfg.loss.get("name", "NCE"),
        extra_losses=tuple(cfg.loss.get("extra_losses", []) or ()),
        seed=int(cfg.seed or 0))
    mean = tuple(cfg.transforms.normalize.mean)
    std = tuple(cfg.transforms.normalize.std)
    deterministic = cfg.runner.get("stable_random", "none") == "none"
    pool = data.train_pool(ctx.seed, dev, t["pool"], t["batch"], t["size"],
                           cfg.model.max_length, ctx.sizes["text"]["vocab"],
                           t["min_caption"], t["regions"])
    if len(pool) < FOLLOWED + 1:
        raise ValueError("the pool needs a batch for each set-up step")

    def feed(host):
        """The runner's ``_prepare_batch``: copies, uint8 images
        normalised on the card, ids as int64."""
        b = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
        if ctx.fault == "half_batch":
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        b["image"] = normalize_images(b["image"], mean, std)
        for k in ("input_ids", "attention_mask"):
            b[k] = b[k].long()
        return b

    if ctx.fault == "unchanged_state":
        optimizer.step = _no_update(optimizer)
    elif ctx.fault == "altered_grad":
        optimizer.step = _altered_grad(optimizer)
    ctx.state.update(model=model, optimizer=optimizer, schedule=schedule,
                     step_fn=step_fn, feed=feed, pool=pool, cfg=cfg,
                     deterministic=deterministic, step=int(t["start_step"]),
                     norm=(mean, std))
    names = optimizer.names
    start = [p.detach().clone() for p in optimizer.params]
    losses, emb = [], []
    beta1 = float(_opt_param(ctx)["param"]["betas"][0])
    # the first step's embeddings, as the model hands them to the loss
    hook = model.register_forward_hook(
        lambda m, args, out: emb.append(tuple(o.detach().float() for o in out[:2])))
    for i in range(FOLLOWED + 1):
        metrics = _step(ctx, i)
        if i == 0:
            hook.remove()
            first = {}
            for n, p in zip(names, optimizer.params):
                m = optimizer.base.state.get(p, {}).get("exp_avg")
                first[n] = (0.0 if m is None else
                            float(torch.linalg.vector_norm(m.double())) / (1.0 - beta1))
        if i < FOLLOWED:
            losses.append(float(metrics["loss"]))
        if i == FOLLOWED - 1:
            change = {n: p.detach() - s for n, p, s in zip(names, optimizer.params, start)}
    del start
    ctx.sync()
    ctx.state["seen"] = {"loss": losses, "grad_norm": first, "change": change,
                         "embed": emb[0]}


def _no_update(optimizer):
    """A step that returns the norm and leaves the state as it was."""
    def step():
        norm = optimizer._norm()
        optimizer.zero_grad()
        return norm
    return step


def _altered_grad(optimizer):
    """The text projection's gradient doubled before the update."""
    real = optimizer.step

    def step():
        for n, p in zip(optimizer.names, optimizer.params):
            if n == "text_projection.linear.weight" and p.grad is not None:
                p.grad.mul_(2.0)
        return real()
    return step


def _step(ctx, k: int):
    """One step on pool batch ``k``: the feed, the lr, the step."""
    st = ctx.state
    with record_function("pb.feed"):
        batch = st["feed"](st["pool"][k % len(st["pool"])])
    lr = st["schedule"](st["step"])
    with record_function("pb.call"):
        metrics = st["step_fn"](batch, lr, st["step"], st["deterministic"])
    st["step"] += 1
    return metrics


def window(ctx) -> None:
    st = ctx.state
    every = int(st["cfg"].log.interval_train)
    host, bad, i = [], 0, 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        metrics = _step(ctx, FOLLOWED + 1 + i)
        host.append(time.perf_counter() - t0)
        i += 1
        if i % every == 0:
            with record_function("pb.readback"):
                bad += not math.isfinite(float(metrics["loss"]))
        if time.perf_counter() - start >= ctx.seconds:
            break
    with record_function("pb.readback"):
        bad += not math.isfinite(float(metrics["loss"]))
    ctx.sync()
    end = time.perf_counter()
    ctx.window.update(seconds=end - start, units=i,
                      items=i * int(ctx.traffic["batch"]), host_s=host)
    ctx.state["nonfinite"] = bad


def traced(ctx, units: int) -> None:
    from pbench import harness

    harness.profile_units(ctx, lambda i: _step(ctx, i), units)


def release(ctx) -> None:
    for k in ("model", "optimizer", "step_fn", "schedule", "feed"):
        ctx.state.pop(k, None)


def follow(ctx, lowp=None) -> dict:
    """The reference's three steps from the run's weights and batches."""
    st = ctx.state
    mean, std = st["norm"]
    opt = _opt_param(ctx)
    cfg = st["cfg"]
    with precise():
        params = {k: v.clone().requires_grad_(True)
                  for k, v in program.state(ctx).items()}
        ref = Ref(params, ctx.sizes, lowp=lowp)
        adamw = ref_train.AdamW(params, tuple(opt["param"]["betas"]),
                                float(opt["param"]["eps"]),
                                float(opt["param"]["weight_decay"]))
        lr_cfg = opt["lr"]
        lrs = [ref_train.lr(int(ctx.traffic["start_step"]) + i, float(lr_cfg["init"]),
                            float(lr_cfg["warmup_proportion"]),
                            int(ctx.traffic["total_steps"]),
                            float(lr_cfg["param"]["num_cycles"]),
                            float(lr_cfg["param"]["min_lr_scale"]))
               for i in range(FOLLOWED)]
        batches = [{k: v.to(ctx.device) for k, v in st["pool"][i].items()}
                   for i in range(FOLLOWED)]
        return ref_train.follow(ref, batches, lrs, adamw, mean, std,
                                cfg.model.pool.loda.image_k,
                                cfg.model.pool.loda.text_k)


def gaps(seen: dict, want: dict) -> dict:
    """The gaps of the loss (the worst step), of the first step's
    embeddings, of the first gradient's norm and of the change's norm (the
    worst tensor), with the tensors the worst were read on. The change is
    compared over the elements the reference moves (``moved``: their
    gradient reaches a thousandth of the median tensor's root-mean-square
    first gradient in some followed step); the others move under Adam by
    round-off alone. The cell's limits file names the numbers compared."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(seen["loss"], want["loss"]))

    def worst(prog, ref):
        med = statistics.median(ref.values())
        vals = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref}
        k = max(vals, key=vals.get)
        return vals[k], k

    grad, grad_at = worst(seen["grad_norm"], want["grad_norm"])
    prog, ref, left = {}, {}, 0
    for k, keep in want["moved"].items():
        left += int(keep.numel() - keep.sum())
        if keep.any():
            prog[k] = float(torch.linalg.vector_norm(seen["change"][k][keep].double()))
            ref[k] = float(torch.linalg.vector_norm(want["change"][k][keep].double()))
    change, change_at = worst(prog, ref)
    return {"loss_gap": loss, "grad_gap": grad, "grad_gap_at": grad_at,
            "change_gap": change, "change_gap_at": change_at,
            "embed_gap": embed_gap(seen["embed"], want["embed"]),
            "left_out": left, "left_out_tensors": sorted(set(want["grad_norm"]) - set(ref))}


def embed_gap(seen, want) -> float:
    """The first step's embeddings against the reference's, the worse of
    the two towers: the gap's norm over the norm of the reference's
    embeddings about their mean row (a random tower maps every input near
    one direction, and the spread about it is what the loss reads).
    Embeddings of another shape read 1."""
    if any(a.shape != b.shape for a, b in zip(seen, want)):
        return 1.0

    def rel(a, b):
        a, b = a.to(b.device).double(), b.double()
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b - b.mean(0, keepdim=True)))

    return max(rel(a, b) for a, b in zip(seen, want))


NUMBERS = ("loss_gap", "grad_gap", "change_gap", "embed_gap")


def judge(ctx):
    want = follow(ctx)
    seen = ctx.state["seen"]
    if ctx.variant is not None:
        # the control in the program's place: the reference with the
        # products of a lower precision
        if ctx.variant not in CONTROLS:
            raise ValueError(f"no control {ctx.variant!r}: {sorted(CONTROLS)}")
        seen = follow(ctx, CONTROLS[ctx.variant])
    g = gaps(seen, want)
    ctx.state["notes"] = {k: g[k] for k in NUMBERS}
    ctx.say(f"compared: grad gap at {g['grad_gap_at']}, change gap at "
            f"{g['change_gap_at']}; left out of the change: {g['left_out']} "
            f"elements, whole tensors {g['left_out_tensors']}")
    lim = ctx.limits["checks"]
    checks = {k: {"value": float(g[k]), "limit": float(v["limit"])}
              for k, v in lim.items()}
    ctx.state.pop("pool", None)
    return checks, int(ctx.state.get("nonfinite", 0))
