"""Tensor (model) parallelism: the Megatron block over a ``'model'`` group
(counterpart: ``deeplearning4j_tpu/parallel/tensor_parallel.py`` —
``init_tp_block_params`` :78, ``TP_BLOCK_SPECS`` :112,
``shard_tp_params`` :96, ``_tp_block_body`` :116, ``tp_block_apply``
:142, ``tp_block_reference`` :162, ``column_parallel_dense`` :189,
``local_head_columns`` :207, ``row_parallel_dense`` :230).

The classic column-then-row pairing: a column-parallel dense (W [F, H]
split on H) computes each rank's slice of the output with no
collective; a row-parallel dense (W [H, F] split on H, the input split
on its last dim) sums the partial products over the group. A block needs
exactly two sums, after attention's output projection and after the
MLP's second product. In the port each rank is a process: the
replicated input enters the column-parallel products through
``parallel/mesh.copy_to`` (its backward sums the ranks' input
gradients) and the row-parallel sum is ``parallel/mesh.psum`` (its
backward passes the replicated cotangent through), so autograd gives
each rank the gradient of its own shards and the whole gradient of the
replicated leaves, the same on every rank.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.device import resolve_device
from deeplearning4j_tpu_torch.parallel.expert_parallel import shard
from deeplearning4j_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    copy_to,
    gather_from,
    group_size,
    psum,
)

Params = Dict[str, torch.Tensor]

TP_BLOCK_SPECS = {
    "ln1_g": (), "ln1_b": (),
    "Wq": (None, MODEL_AXIS), "Wk": (None, MODEL_AXIS),
    "Wv": (None, MODEL_AXIS), "Wo": (MODEL_AXIS, None),
    "ln2_g": (), "ln2_b": (),
    "W1": (None, MODEL_AXIS), "b1": (MODEL_AXIS,),
    "W2": (MODEL_AXIS, None), "b2": (),
}


def init_tp_block_params(seed: int, d_model: int, d_ff: int, num_heads: int,
                         dtype=torch.float32, device=None) -> Params:
    """A transformer block's params (global shapes), xavier weights through
    the port's ``nn/weights.init_weights`` from a ``torch.Generator``
    seeded with ``seed``."""
    from deeplearning4j_tpu_torch.nn.weights import init_weights

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def xavier(shape):
        return init_weights(gen, shape, "xavier", shape[0], shape[-1],
                            dtype=dtype)

    d, f = d_model, d_ff
    ones = lambda n: torch.ones((n,), dtype=dtype, device=dev)
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=dev)
    return {
        "ln1_g": ones(d), "ln1_b": zeros(d),
        "Wq": xavier((d, d)), "Wk": xavier((d, d)), "Wv": xavier((d, d)),
        "Wo": xavier((d, d)),
        "ln2_g": ones(d), "ln2_b": zeros(d),
        "W1": xavier((d, f)), "b1": zeros(f),
        "W2": xavier((f, d)), "b2": zeros(d),
    }


def shard_tp_params(params: Params, mesh, axis: str = MODEL_AXIS) -> Params:
    """This rank's shards under :data:`TP_BLOCK_SPECS` (1/p of every split
    matrix) on ``mesh`` (a ``MeshGroups``); ``axis`` renames the model
    axis."""
    sizes = {MODEL_AXIS: mesh.size(axis)}
    indices = {MODEL_AXIS: mesh.index(axis)}
    return {k: shard(v, TP_BLOCK_SPECS[k], sizes, indices)
            for k, v in params.items()}


def _layer_norm(x, g, b, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def _attention(q, k, v, causal: bool):
    d = q.shape[-1]
    s = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(d)
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask[None, None], float("-inf"))
    return torch.einsum("nhqk,nkhd->nqhd", torch.softmax(s, dim=-1), v)


def _tp_block_body(p: Params, x, *, num_heads_local: int, causal: bool,
                   group):
    """One block on one rank: x [N, T, F] replicated, ``p`` this rank's
    shards."""
    h = copy_to(_layer_norm(x, p["ln1_g"], p["ln1_b"]), group)
    n, t, _ = h.shape
    q = (h @ p["Wq"]).reshape(n, t, num_heads_local, -1)
    k = (h @ p["Wk"]).reshape(n, t, num_heads_local, -1)
    v = (h @ p["Wv"]).reshape(n, t, num_heads_local, -1)
    att = _attention(q, k, v, causal).reshape(n, t, -1)
    x = x + psum(att @ p["Wo"], group)
    h = copy_to(_layer_norm(x, p["ln2_g"], p["ln2_b"]), group)
    inner = F.gelu(h @ p["W1"] + p["b1"], approximate="tanh")
    return x + psum(inner @ p["W2"], group) + p["b2"]


def tp_block_apply(params: Params, x, group, *, num_heads: int,
                   causal: bool = True):
    """One tensor-parallel block over ``group``: x [N, T, F] replicated,
    ``params`` this rank's :func:`shard_tp_params` shards; the output is
    replicated."""
    p_size = group_size(group)
    if num_heads % p_size != 0:
        raise ValueError(f"num_heads {num_heads} not divisible by "
                         f"model-axis size {p_size}")
    return _tp_block_body(params, x, num_heads_local=num_heads // p_size,
                          causal=causal, group=group)


def tp_block_reference(params: Params, x, *, num_heads: int,
                       causal: bool = True):
    """The same block on one device with whole params (the oracle)."""
    n, t, f = x.shape
    h = _layer_norm(x, params["ln1_g"], params["ln1_b"])
    q = (h @ params["Wq"]).reshape(n, t, num_heads, -1)
    k = (h @ params["Wk"]).reshape(n, t, num_heads, -1)
    v = (h @ params["Wv"]).reshape(n, t, num_heads, -1)
    x = x + _attention(q, k, v, causal).reshape(n, t, f) @ params["Wo"]
    h = _layer_norm(x, params["ln2_g"], params["ln2_b"])
    inner = F.gelu(h @ params["W1"] + params["b1"], approximate="tanh")
    return x + inner @ params["W2"] + params["b2"]


def column_parallel_dense(W, b, x, group, *, gather: bool = True):
    """y = x @ W + b with this rank's column shard W [F, H/p], b [H/p];
    ``gather`` concatenates the ranks' outputs back to [.., H] (False
    keeps this rank's [.., H/p] for a row-parallel dense)."""
    y = copy_to(x, group) @ W + b
    return gather_from(y, group, dim=-1) if gather else y


def local_head_columns(W, *, num_heads: int, head_dim: int, n_devices: int,
                       index: int):
    """This rank's head columns of a whole projection W [F, H * hd]: the
    column-parallel split in its bytewise form (each output column is its
    own dot product, so the slice of the product is the product of the
    slice)."""
    cols = (num_heads // n_devices) * head_dim
    return W[:, index * cols:(index + 1) * cols]


def row_parallel_dense(W, b, x_sharded, group):
    """y = x @ W + b with this rank's row shard W [H/p, F] and input
    columns x [.., H/p]; one sum replicates the output."""
    return psum(x_sharded @ W, group) + b
