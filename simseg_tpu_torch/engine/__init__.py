"""The train and eval steps, plain and BSGS (port of ``simseg_tpu/engine``).

JAX's public table (``simseg_tpu/engine/__init__.py``), each name imported
from its submodule on first use, so ``import simseg_tpu_torch.engine``
imports no submodule. JAX names with no counterpart (``NO_COUNTERPART``):

- ``TrainState``: JAX's step carries its parameters and optax state in one
  pytree; the port's state is the model and its ``core/optim.Optimizer``;
- ``opt_state_sharding``: the ``jax.sharding`` layout of optax's state; a
  port rank holds its own slices (ZeRO-1 in ``core/optim.py``).
"""

from simseg_tpu_torch import lazy_package

_PUBLIC = {name: (f"simseg_tpu_torch.engine.{module}", name)
           for module, names in (
               ("train_step", ("clip_loss_fn", "make_eval_step",
                               "make_train_step")),
               ("bsgs", ("make_bsgs_grad_fn", "make_bsgs_train_step")),
           ) for name in names}
NO_COUNTERPART = ("TrainState", "opt_state_sharding")
__all__ = list(_PUBLIC)
__getattr__, __dir__ = lazy_package(__name__, _PUBLIC)
