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
- :func:`moe_cases` — the MoE layer with its experts split over ``ep``;
- :func:`pipeline_cases` — GPipe, 1F1B and the interleaved schedule through
  their global-view ``make_*`` functions on sub-meshes of the world (outputs,
  gradients of ``sum(out²)``, losses and gradient trees, their errors, what
  each rank's schedule ran), with an MLP stage or a run of Llama decoder
  layers (:func:`llama_stage_fn`).
"""

from __future__ import annotations

import dataclasses
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


# ---------------------------------------------------------------------------
# Pipeline schedules
# ---------------------------------------------------------------------------


def mlp_stage_fn(stage_params, x):
    """The reference test's stage: its stacked layers in order, each
    ``tanh(x @ w + b)``."""
    for i in range(stage_params["w"].shape[0]):
        x = torch.tanh(x @ stage_params["w"][i] + stage_params["b"][i])
    return x


def mse(y, tgt):
    """The mean squared error, in f32 whatever the activations' dtype."""
    return ((y.float() - tgt.float()) ** 2).mean()


def llama_stage_fn(config, attn_fn, seq_len: int, device, *, jitted: bool = False):
    """A pipeline stage of Llama decoder layers: ``(stacked layer slice,
    hidden [mb, T, D]) → hidden``, each layer the model's own
    ``_layer_fwd`` with ``attn_fn`` (the embedding, the final norm and the
    head stay outside the pipe)."""
    from rayfed_tpu_torch.models import llama

    cos, sin = llama.rope_tables(torch.arange(seq_len, device=device), config.head_dim, config.rope_theta)

    def stage(stage_params, x):
        b, t = x.shape[0], x.shape[1]
        for i in range(next(iter(stage_params.values())).shape[0]):
            x, _ = llama._layer_fwd(x, {k: w[i] for k, w in stage_params.items()}, config, cos, sin,
                                    attn_fn, b, t, jitted=jitted)
        return x

    return stage


def _pipe_fns(case, device):
    if case.get("llama") is None:
        return mlp_stage_fn, mse
    from rayfed_tpu_torch.models import llama

    dtype = _DTYPES[case.get("dtype", "float32")]
    cfg = llama.llama_tiny(**case["llama"], dtype=dtype, param_dtype=dtype)
    return llama_stage_fn(cfg, flash_attention, case["x"].shape[1], device, jitted=True), mse


def _pipe_case(case: Dict[str, Any], device: torch.device, meshes) -> Dict[str, Any]:
    from torch.utils import _pytree as pytree

    from rayfed_tpu_torch.parallel import pipeline as pp

    n = case["stages"]
    mesh = meshes(n)
    if mesh is None:  # this rank lies outside the case's sub-mesh
        return {}
    stage_fn, loss_fn = _pipe_fns(case, device)
    dtype = _DTYPES[case.get("dtype", "float32")]
    params = pytree.tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype),
                             case["params"])
    x = torch.from_numpy(np.asarray(case["x"], np.float32)).to(device, dtype)
    kind, m = case["kind"], case["mb"]
    _zero_launches()
    pp.STATS.reset()
    res: Dict[str, Any] = {}
    if kind == "gpipe":
        res["out"] = _np(pp.make_pipeline(mesh, stage_fn, num_microbatches=m)(params, x))
    elif kind == "gpipe_grad":
        leaves, spec = pytree.tree_flatten(params)
        leaves = [leaf.requires_grad_(True) for leaf in leaves]
        out = pp.make_pipeline(mesh, stage_fn, num_microbatches=m)(pytree.tree_unflatten(leaves, spec), x)
        grads = torch.autograd.grad((out ** 2).sum(), leaves)
        res["grads"] = _np_tree(pytree.tree_unflatten(list(grads), spec))
    elif kind == "gpipe_loss_grad":  # the mean microbatch loss through GPipe, by autograd
        tgt = torch.from_numpy(np.asarray(case["tgt"], np.float32)).to(device)
        leaves, spec = pytree.tree_flatten(params)
        leaves = [leaf.requires_grad_(True) for leaf in leaves]
        y = pp.make_pipeline(mesh, stage_fn, num_microbatches=m)(pytree.tree_unflatten(leaves, spec), x)
        b = x.shape[0] // m
        loss = torch.stack([loss_fn(y[i * b:(i + 1) * b], tgt[i * b:(i + 1) * b]) for i in range(m)]).mean()
        res["loss"] = float(loss.detach())
        res["grads"] = _np_tree(pytree.tree_unflatten(list(torch.autograd.grad(loss, leaves)), spec))
    elif kind == "train":
        tgt = torch.from_numpy(np.asarray(case["tgt"], np.float32)).to(device, dtype)
        train = pp.make_pipeline_train(mesh, stage_fn, loss_fn, num_microbatches=m,
                                       virtual_stages=case.get("v", 1))
        loss, grads = train(params, x, tgt)
        res["loss"], res["grads"] = float(loss), _np_tree(grads)
    elif kind == "sgd":  # plain SGD steps on the 1F1B gradients: the losses
        tgt = torch.from_numpy(np.asarray(case["tgt"], np.float32)).to(device)
        train = pp.make_pipeline_train(mesh, stage_fn, loss_fn, num_microbatches=m)
        res["losses"] = []
        for _ in range(case["steps"]):
            loss, grads = train(params, x, tgt)
            res["losses"].append(float(loss))
            params = pytree.tree_map(lambda p, g: p - case["lr"] * g, params, grads)
    res["launches"] = _launches()
    res["stats"] = dataclasses.asdict(pp.STATS)
    return res


def _np_tree(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(_np, tree)


def _pipe_errors(device, meshes) -> Dict[str, str]:
    """The ``make_*`` functions' ValueErrors, each message as raised (mesh pp=4)."""
    from rayfed_tpu_torch.parallel import pipeline as pp

    mesh = meshes(4)
    if mesh is None:
        return {}
    six = {"w": torch.zeros(6, 8, 8, device=device), "b": torch.zeros(6, 8, device=device)}
    four = {"w": torch.zeros(4, 8, 8, device=device), "b": torch.zeros(4, 8, device=device)}
    eight = {"w": torch.zeros(8, 8, 8, device=device), "b": torch.zeros(8, 8, device=device)}
    x8, x9, x6 = (torch.zeros(r, 8, device=device) for r in (8, 9, 6))
    calls = {
        "leading": lambda: pp.make_pipeline(mesh, mlp_stage_fn, num_microbatches=4)(six, x8),
        "batch": lambda: pp.make_pipeline(mesh, mlp_stage_fn, num_microbatches=4)(four, x9),
        "virtual_leading": lambda: pp.make_pipeline_train(
            mesh, mlp_stage_fn, mse, num_microbatches=4, virtual_stages=2)(six, x8, x8),
        "virtual_stages": lambda: pp.make_pipeline_train(
            mesh, mlp_stage_fn, mse, num_microbatches=4, virtual_stages=0),
        "interleaved_mb": lambda: pp.make_pipeline_train(
            mesh, mlp_stage_fn, mse, num_microbatches=6, virtual_stages=2)(eight, x6, x6),
        "train_batch": lambda: pp.make_pipeline_train(mesh, mlp_stage_fn, mse, num_microbatches=4)(four, x9, x9),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def pipeline_cases(rank: int, device: torch.device, cases: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Run each named case on the sub-mesh ``{"pp": stages}`` over the
    world's first ``stages`` ranks (ranks outside it report ``{}``), then
    (in a world of 4 ranks or more) the ``make_*`` functions' errors on ``{"pp": 4}``."""
    made: Dict[int, Any] = {}
    world = torch.distributed.get_world_size()

    def meshes(n):
        if n not in made:  # collective: every rank builds every mesh, in one order
            made[n] = create_mesh({"pp": n}, list(range(n)), device=device.type)
        return made[n] if rank < n else None

    for n in sorted({c["stages"] for c in cases.values()} | ({4} if world >= 4 else set())):
        meshes(n)
    results = {name: _pipe_case(case, device, meshes) for name, case in cases.items()}
    results["errors"] = _pipe_errors(device, meshes) if world >= 4 else {}
    return results
