"""Rank programs that hold the party-local parallel ops to given inputs.

Each function runs on every rank of a world started by
:func:`rayfed_tpu_torch.parallel.launch.run_world` and returns numpy
results, which the caller holds against a reference: the JAX package's
functions in the tests on the CPU, one-card ``flash_attention`` in the card
tests.  Inputs arrive as numpy arrays, the same on every rank.

- :func:`attention_cases` — ring, flash ring, zigzag and Ulysses through
  their global-view builders (outputs, gradients of ``sum(out²)``, the flash
  kernels' launches, the errors the builders raise), and a Llama forward
  with ring attention as its ``attn_fn``;
- :func:`mesh_checks` — mesh shapes and errors, partition-rule specs, the
  data-parallel strategy and a tensor-parallel matmul;
- :func:`moe_cases` — the MoE layer with its experts split over ``ep``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from rayfed_tpu_torch.ops.flash_attention import flash_attention
from rayfed_tpu_torch.parallel import collectives as coll
from rayfed_tpu_torch.parallel.mesh import create_mesh

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _launches() -> Dict[str, int]:
    return {n: getattr(flash_attention, f"{n}_launches") for n in ("fwd", "bwd_dq", "bwd_dkv")}


def _zero_launches() -> None:
    for n in ("fwd", "bwd_dq", "bwd_dkv"):
        setattr(flash_attention, f"{n}_launches", 0)


class _Meshes:
    """Meshes by shape: building one is collective, so each is built once,
    in the same order on every rank."""

    def __init__(self, device: torch.device):
        self.device, self._made = device, {}

    def __call__(self, shape: Dict[str, int]):
        key = tuple(shape.items())
        if key not in self._made:
            self._made[key] = create_mesh(dict(shape), device=self.device.type)
        return self._made[key]


def _attn_fn(name):
    if name == "flash":
        return flash_attention
    if name is None:
        return None
    raise ValueError(f"unknown attn_fn {name!r}")


def _attention_case(case: Dict[str, Any], meshes: _Meshes, device: torch.device) -> Dict[str, Any]:
    from rayfed_tpu_torch.ops import make_ring_attention, make_ulysses_attention

    mesh = meshes(case["mesh"])
    if case["op"] == "llama":
        return _llama_case(case, mesh, device)
    kw = dict(case.get("kw", {}))
    if case["op"] == "ring":
        fn = make_ring_attention(mesh, "sp", **kw)
    else:
        kw["attn_fn"] = _attn_fn(kw.get("attn_fn"))
        fn = make_ulysses_attention(mesh, "sp", **kw)
    dtype = _DTYPES[case.get("dtype", "float32")]
    grad = case.get("grad", False)
    q, k, v = (torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype).requires_grad_(grad)
               for a in case["qkv"])
    _zero_launches()
    out = fn(q, k, v, **case.get("call_kw", {}))
    res = {"out": _np(out), "dtype": str(out.dtype).replace("torch.", "")}
    if grad:
        res["grads"] = [_np(g) for g in torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))]
    res["launches"] = _launches()
    return res


def _llama_case(case, mesh, device):
    from rayfed_tpu_torch.models import llama
    from rayfed_tpu_torch.models.convert import llama_params_from_jax
    from rayfed_tpu_torch.ops import make_ring_attention

    cfg = llama.llama_tiny(**case.get("cfg", {}))
    params = llama_params_from_jax(case["params"], device)
    ids = torch.from_numpy(np.asarray(case["ids"])).to(device)
    ring = make_ring_attention(mesh, "sp", **case["kw"])
    res = {"out": _np(llama.apply_llama(params, ids, cfg, attn_fn=ring))}
    try:
        llama.apply_llama(params, ids, cfg, attn_fn=make_ring_attention(mesh, "sp", **case["bad_kw"]))
        res["bad_error"] = None
    except ValueError as e:
        res["bad_error"] = str(e)
    return res


def attention_cases(rank: int, device: torch.device, cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Run each case (see the module note); a case that raises ``ValueError``
    reports ``{"error": message}``."""
    meshes, results = _Meshes(device), []
    for case in cases:
        try:
            results.append(_attention_case(case, meshes, device))
        except ValueError as e:
            results.append({"error": str(e)})
    results.append({"backend": torch.distributed.get_backend(), "staged_bytes": coll.STAGING.bytes})
    return results


def _specs(shardings) -> Dict[str, tuple]:
    from torch.utils import _pytree as pytree

    from rayfed_tpu_torch.parallel.sharding import _path_str

    flat, _ = pytree.tree_flatten_with_path(shardings)
    return {_path_str(path): s.spec for path, s in flat}


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def mesh_checks(rank: int, device: torch.device, rule_sets: Dict[str, Any]) -> Dict[str, Any]:
    """Mesh shapes and errors, rule specs, the DP strategy and a TP matmul.

    ``rule_sets``: name → (model, config keywords, mesh shape); the specs of
    that model's params under its ``PARTITION_RULES`` come back by path."""
    from rayfed_tpu_torch.models import bert, llama, moe, resnet
    from rayfed_tpu_torch.parallel.mesh import mesh_axis_size
    from rayfed_tpu_torch.parallel.sharding import (
        ShardingStrategy,
        data_parallel,
        shard_params_by_rules,
    )

    dt = device.type
    shape = lambda m: {n: mesh_axis_size(m, n) for n in m.mesh_dim_names}  # noqa: E731
    res: Dict[str, Any] = {
        "dp_tp": shape(create_mesh({"dp": 2, "tp": 2}, device=dt)),
        "dp_infer": shape(create_mesh({"dp": 2, "tp": -1}, device=dt)),
        "default": shape(create_mesh(device=dt)),
        "err_size": _error(lambda: create_mesh({"dp": 3}, device=dt)),
        "err_two": _error(lambda: create_mesh({"dp": -1, "tp": -1}, device=dt)),
        "err_infer": _error(lambda: create_mesh({"dp": 3, "tp": -1}, device=dt)),
    }
    mesh = create_mesh({"dp": 2, "tp": 2}, device=dt)
    res["rules"] = _specs(shard_params_by_rules(
        mesh,
        {"dense": {"kernel": torch.ones(8, 16), "bias": torch.ones(16)}, "emb": {"embedding": torch.ones(32, 8)}},
        rules=[(r"dense/kernel", (None, "tp")), (r"embedding", ("tp", None))],
    ))
    dp_mesh = create_mesh({"dp": 4}, device=dt)
    res["pruned"] = _specs(shard_params_by_rules(dp_mesh, {"k": torch.ones(4, 4)}, rules=[(r"k", (None, "tp"))]))

    strat = data_parallel(dp_mesh)
    batch = strat.shard_batch({"x": torch.ones(16, 4), "y": torch.ones(16)})
    res["batch_spec"] = strat.batch_sharding(ndim=2).spec
    res["batch_local_rows"] = batch["x"].to_local().shape[0]
    params = strat.shard_params({"w": torch.ones(4, 2), "b": torch.ones(2)})
    step = strat.jit_step(lambda p, bt: (bt["x"] @ p["w"] + p["b"]).mean())
    res["dp_out"] = float(step(params, batch).full_tensor())

    tp = ShardingStrategy(mesh=mesh, batch_axes=("dp",), param_rules=((r"w", (None, "tp")),))
    w = tp.shard_params({"w": torch.arange(32.0).reshape(4, 8)})
    x = tp.shard_batch(torch.ones(8, 4))
    res["tp_local_w"] = tuple(w["w"].to_local().shape)
    res["tp_out"] = _np(tp.jit_step(lambda p, x: x @ p["w"])(w, x).full_tensor())

    gen = torch.Generator(device=device).manual_seed(0)
    models = {
        "llama": lambda kw: llama.init_llama(llama.llama_tiny(**kw), gen, device),
        "resnet": lambda kw: resnet.init_resnet(gen, resnet.resnet18(**kw), device=device)[0],
        "bert": lambda kw: bert.init_bert(bert.BertConfig(**kw), gen, device),
        "moe": lambda kw: moe.init_moe(moe.MoeConfig(**kw), gen, device),
    }
    rules = {"llama": llama.PARTITION_RULES, "resnet": resnet.PARTITION_RULES,
             "bert": bert.PARTITION_RULES, "moe": moe.PARTITION_RULES}
    for name, (model, kw, mesh_shape) in rule_sets.items():
        m = create_mesh(dict(mesh_shape), device=dt)
        res[name] = _specs(shard_params_by_rules(m, models[model](kw), rules[model]))
    return res


def moe_cases(rank: int, device: torch.device, cases: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The MoE layer on the JAX package's params and inputs, its experts
    split over an ``ep`` mesh axis (as DTensor ``Shard(0)`` leaves placed by
    ``PARTITION_RULES``); output, aux loss and the gradients of
    ``sum(out²) + aux`` by leaf."""
    from rayfed_tpu_torch.models import moe
    from rayfed_tpu_torch.models.convert import moe_params_from_jax
    from rayfed_tpu_torch.parallel.sharding import ShardingStrategy

    meshes, results = _Meshes(device), []
    for case in cases:
        mesh = meshes(case["mesh"])
        cfg = moe.MoeConfig(**case["cfg"])
        strat = ShardingStrategy(mesh=mesh, param_rules=moe.PARTITION_RULES)
        params = strat.shard_params(moe_params_from_jax(case["params"], device))
        for leaf in params.values():
            leaf.requires_grad_(True)
        x = torch.from_numpy(np.asarray(case["x"], np.float32)).to(device).requires_grad_(True)
        local = {n: (p.to_local() if n == "gate" else p) for n, p in params.items()}
        out, aux = moe.apply_moe(local, x, cfg, return_aux=True, dispatch=case.get("dispatch", "scatter"),
                                 ep_group=mesh.get_group("ep"))
        loss = (out**2).sum() + aux["aux_loss"]
        names = sorted(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names] + [x])
        results.append({
            "out": _np(out),
            "aux_loss": float(aux["aux_loss"]),
            "dropped_fraction": float(aux["dropped_fraction"]),
            "local_experts": tuple(params["w_in"].to_local().shape),
            "grads": {n: _np(g.full_tensor()) for n, g in zip(names, grads[:-1])} | {"x": _np(grads[-1])},
        })
    return results
