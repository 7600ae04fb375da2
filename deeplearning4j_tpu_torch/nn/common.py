"""The per-layer application policy of the containers (counterpart:
``deeplearning4j_tpu/nn/common.py`` — ``tbptt_backprop_window``,
``compute_dtype_of``, ``cast_for_compute``, ``apply_layer``,
``cast_loss_input``, ``remat_apply`` and ``decay_lr_scale_entry``; and the
train step both containers share, with the bf16 loss-scaled branch of
``MultiLayerNetwork._build_lowprec_step`` (``nn/multilayer.py:344-411``)
and ``ComputationGraph._build_lowprec_step`` (``nn/graph.py:474-538``)).

Under ``dtype_policy="performance"`` a layer's f32 params and input are
cast to bf16 for its computation; output and normalization layers (BN's
batch statistics, LRN's square sums) are never downcast (a bf16 input is
upcast to f32 for them), and a cast layer's returned
recurrent state is cast back to f32 so stored states keep one dtype.
In training a layer runs under the remat ladder (``ops/remat.py``): a
``DL4J_TPU_REMAT`` policy other than ``none`` wins, else
``conf.gradient_checkpointing`` means ``block``. The policy is read in
training only (the JAX package reads it at every trace).

``train_iteration`` is one optimizer iteration of a container. Under
``DL4J_TPU_BF16`` (read at every step, as the JAX package reads it when a
step is built) it casts the f32 master params and the floating inputs to
bf16 at the step boundary, scales the loss by the container's dynamic
loss scale before the backward, unscales the f32 gradients, and on a
non-finite gradient keeps the params, the layer states and the updater
state as they were (selected on the device: no host read) while the
scale halves; ``ops/lowprec.advance_scale`` moves the scale either way.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayerImpl
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalizationImpl,
    LocalResponseNormalizationImpl,
)
from deeplearning4j_tpu_torch.ops import lowprec
from deeplearning4j_tpu_torch.ops.lowprec import tree_leaves, tree_map
from deeplearning4j_tpu_torch.ops.remat import remat_policy, remat_wrap
from deeplearning4j_tpu_torch.optimize.updaters import apply_updates

# layers that compute in f32 under the performance policy
_NEVER_CAST = (OutputLayerImpl, BatchNormalizationImpl,
               LocalResponseNormalizationImpl)


def tbptt_backprop_window(conf) -> Optional[int]:
    """The in-window TBPTT backward length, or None when it is not shorter
    than the forward length."""
    back = conf.tbptt_back_length
    if back and back < conf.tbptt_fwd_length:
        return back
    return None


def compute_dtype_of(conf) -> Optional[torch.dtype]:
    """bf16 for the ``performance`` policy, None for strict f32."""
    if getattr(conf, "dtype_policy", "strict") == "performance":
        return torch.bfloat16
    return None


def cast_for_compute(params, x, dtype):
    """Cast the input and the layer's f32 params to ``dtype``; only f32 is
    downcast (f64 and integer tensors pass through)."""
    cast = lambda a: a.to(dtype) if a.dtype == torch.float32 else a
    return tree_map(cast, params), cast(x)


def apply_layer(layer, conf, params, state, x, gen, mask, kwargs=None, *,
                train: bool = False):
    """One layer under the container's policy: the dtype cast, then
    ``layer.apply`` with the dropout generator ``gen``, the mask and the
    layer's extra ``kwargs`` (carry_state, backprop_window)."""
    compute_dtype = compute_dtype_of(conf)
    cast_active = (compute_dtype is not None
                   and not isinstance(layer, _NEVER_CAST))
    if cast_active:
        params, x = cast_for_compute(params, x, compute_dtype)
    elif compute_dtype is not None and x.dtype == compute_dtype:
        x = x.to(torch.float32)
    effective = "none"
    if train:
        env_policy = remat_policy("auto")
        effective = env_policy if env_policy != "none" else (
            "block" if conf.gradient_checkpointing else "none")
    if effective != "none":
        y, new_state = remat_apply(layer, params, state, x, gen, mask,
                                   kwargs, policy=effective)
    else:
        y, new_state = layer.apply(params, state, x, train=train, gen=gen,
                                   mask=mask, **(kwargs or {}))
    if cast_active and new_state:
        new_state = {k: v.to(torch.float32) if v.dtype == compute_dtype
                     else v for k, v in new_state.items()}
    return y, new_state


def cast_loss_input(x: torch.Tensor) -> torch.Tensor:
    """Loss math stays at f32 or wider: bf16 and f16 are upcast."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.to(torch.float32)
    return x


def promote_to(params, x: torch.Tensor):
    """``params`` with every narrower floating leaf cast up to ``x``'s
    dtype: the output layer's bf16 params against its f32 loss input under
    bf16 training, which the JAX package's type promotion computes in f32
    (the cast up is exact)."""
    def up(a):
        if (a.is_floating_point() and a.dtype != x.dtype
                and a.element_size() < x.element_size()):
            return a.to(x.dtype)
        return a
    return tree_map(up, params)


def train_iteration(net, loss_fn, inputs):
    """One optimizer iteration of ``net`` (a MultiLayerNetwork or a
    ComputationGraph): ``loss_fn(params, inputs) -> (loss, new states)``,
    its gradients by autograd (averaged by ``net._grad_reduce(loss,
    grads)`` when a data-parallel wrapper sets it), ``net.updater`` and
    the parameter step in place. Returns (the loss, the new states,
    detached). Under bf16 training see the module docstring; the loss
    returned is f32."""
    leaves = tree_map(lambda v: v.detach().requires_grad_(True), net.params)
    scaled = lowprec.train_policy()
    if scaled:
        ls = net._ensure_loss_scale()
    with torch.enable_grad():
        if scaled:
            loss, new_states = loss_fn(lowprec.cast_tree(leaves),
                                       tree_map(lowprec.cast_array, inputs))
            loss = loss.to(torch.float32)
            target = loss * ls["scale"]
        else:
            loss, new_states = loss_fn(leaves, inputs)
            target = loss
        flat = iter(torch.autograd.grad(target, tree_leaves(leaves),
                                        materialize_grads=True))
    grads = tree_map(lambda _: next(flat), leaves)
    reduce = getattr(net, "_grad_reduce", None)
    if reduce is not None:  # a data-parallel wrapper's average
        loss, grads = reduce(loss, grads)
    new_states = tree_map(torch.Tensor.detach, new_states)
    if not scaled:
        updates, net.updater_state = net.updater.update(
            grads, net.updater_state, net.params, net.iteration)
        apply_updates(net.params, updates, net.conf.minimize)
        return loss.detach(), new_states
    grads = lowprec.unscale(grads, ls["scale"])
    finite = lowprec.finite_tree(grads)
    old_upd = tree_map(_clone, net.updater_state)
    updates, new_upd = net.updater.update(
        grads, net.updater_state, net.params, net.iteration)
    zero = lambda u: torch.where(finite, u, torch.zeros_like(u))
    apply_updates(net.params, tree_map(zero, updates), net.conf.minimize)
    with torch.no_grad():
        tree_map(lambda n, o: n.copy_(torch.where(finite, n, o))
                 if torch.is_tensor(n) else None, new_upd, old_upd)
    net.updater_state = new_upd
    net._loss_scale = lowprec.advance_scale(ls, finite)
    return loss.detach(), tree_map(lambda n, o: _keep(finite, n, o),
                                   new_states, net.states)


def _clone(v):
    return v.clone() if torch.is_tensor(v) else v


class LossScaled:
    """What both containers keep of bf16 training: the dynamic loss scale
    (``_loss_scale``, made at first use on ``self.device``), its host
    snapshot (``loss_scale``, which syncs
    ``dispatch_stats.loss_scale_skips``), and the exact-resume extras
    (``training_state``: the iteration and, once bf16 training ran, the
    scale; the dropout streams' base is ``conf.seed``, so no generator
    state is kept, and a JAX zip's ``rng`` key is ignored)."""

    def _ensure_loss_scale(self) -> dict:
        if self._loss_scale is None:
            self._loss_scale = lowprec.init_scale_state(self.device)
        return self._loss_scale

    @property
    def loss_scale(self):
        """Host snapshot of the dynamic loss-scale state (None when bf16
        training never ran): a sync point."""
        snap = lowprec.scale_snapshot(self._loss_scale)
        if snap is not None:
            self.dispatch_stats.loss_scale_skips = snap["skipped"]
        return snap

    def training_state(self) -> dict:
        st = {"iteration": int(self.iteration)}
        snap = self.loss_scale
        if snap is not None:
            st["loss_scale"] = snap
        return st

    def restore_training_state(self, st: dict) -> None:
        if st.get("iteration") is not None:
            self.iteration = int(st["iteration"])
        if st.get("loss_scale") is not None:
            self._loss_scale = lowprec.scale_from_snapshot(
                st["loss_scale"], device=self.device)


def _keep(finite, new, old):
    """A layer state leaf after a loss-scaled step, in the stored dtype:
    the new one, or the old one when the step was skipped; a stream state
    sized for another batch (the cleared (0, n) form) has no old value
    and reads zero."""
    new = new.to(old.dtype)
    if new.shape != old.shape:
        return torch.where(finite, new, torch.zeros_like(new))
    return torch.where(finite, new, old)


def remat_apply(layer, params, state, x, gen, mask, kwargs, policy: str):
    """A training ``layer.apply`` under a rung of the remat ladder: the
    backward recomputes the layer's activations (``block``) or all but its
    products' outputs (``dots``). The dropout generator is replayed from
    its state at the call, so the recompute draws the same masks."""
    gen_state = None if gen is None else gen.get_state()

    def run(p, s, xx):
        g = gen
        if gen_state is not None:
            g = torch.Generator(device=gen.device)
            g.set_state(gen_state)
        return layer.apply(p, s, xx, train=True, gen=g, mask=mask,
                           **(kwargs or {}))

    return remat_wrap(run, policy)(params, state, x)


def decay_lr_scale_entry(state, rate: float):
    """One layer's updater state with its ``lr_scale`` (the ``score`` LR
    policy's cumulative decay) multiplied by ``rate``; a state without it
    passes through."""
    if isinstance(state, dict) and "lr_scale" in state:
        return {**state, "lr_scale": state["lr_scale"] * rate}
    return state
