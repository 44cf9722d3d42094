"""The harness's parts on the CPU: discovery by name, the interval and
window arithmetic, the imports, BENCHMARK.json against the files, and the
plain references against the program's CPU path at tiny sizes."""

import ast
import json
import shutil

import pytest
import torch

from fedbench import devtrace, judge, spec, traffic
from fedbench.reference import fold_mean
from fedbench.reference import llama as llama_ref
from fedbench.reference import resnet as resnet_ref

ROOT = spec.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "rayfed_tpu"}


def test_parts_are_found_by_name(tmp_path, monkeypatch):
    """A new configuration, cell or metric is a new file, and nothing else."""
    copy = tmp_path / "fedbench"
    shutil.copytree(spec.HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    monkeypatch.setattr(spec, "HERE", copy)
    before = (spec.names("configs"), spec.names("workloads"), set(spec.metrics()))
    cfg = json.loads((copy / "configs" / "resnet18_cifar10.json").read_text())
    (copy / "configs" / "resnet34_new.json").write_text(json.dumps({**cfg, "stage_sizes": [3, 4, 6, 3]}))
    wl = json.loads((copy / "workloads" / "resnet18.hub4_b64.json").read_text())
    (copy / "workloads" / "resnet34.new_cell.json").write_text(json.dumps({**wl, "config": "resnet34_new"}))
    (copy / "metrics" / "new.metric_ms.py").write_text(
        'TRACE, UNIT, LAYER, MOVES = 1, "ms", "device", "round_s"\n\n\ndef read(ctx):\n    return 1.0\n')
    assert spec.names("configs") == sorted(before[0] + ["resnet34_new"])
    assert spec.names("workloads") == sorted(before[1] + ["resnet34.new_cell"])
    assert set(spec.metrics()) == before[2] | {"new.metric_ms"}
    new_wl, new_cfg = spec.cell("resnet34.new_cell")
    assert new_cfg["stage_sizes"] == [3, 4, 6, 3] and new_wl["batch"] == wl["batch"]


def test_union_and_gaps():
    busy = devtrace.union([(1, 3), (2, 4), (6, 7), (9, 12), (-1, 0.5)], 0, 10)
    assert busy == [[0, 0.5], [1, 4], [6, 7], [9, 10]]
    assert devtrace.gaps(busy, 0, 10) == [(0.5, 1), (4, 6), (7, 9)]
    assert devtrace.union([], 0, 1) == [] and devtrace.gaps([], 0, 1) == [(0, 1)]
    assert devtrace.short_name("void flash_fwd_wgmma<128, __nv_bfloat16>(CUtensorMap, int)") == "flash_fwd_wgmma"
    assert devtrace.short_name("(anonymous namespace)::flash_bwd_dq_wgmma<128, __nv_bfloat16>(CUtensorMap_st, C") \
        == "flash_bwd_dq_wgmma"


def test_window_arithmetic():
    m = spec.metrics()
    reports = {"alice": {"marks": {1: (10.0, 100), 4: (13.0, 700)}, "peak_bytes": 2**31},
               "bob": {"marks": {1: (10.1, 50), 4: (13.1, 350)}, "peak_bytes": 2**30}}
    ctx = {"window": {"t0": 10.0, "t1": 13.0, "r0": 1, "r1": 4, "rounds": 3}, "t_cmd0": 2.5,
           "reports": reports, "platform": "gpu"}
    assert m["round_s.llama"].read(ctx) == m["round_s.resnet"].read(ctx) == 1.0
    assert m["setup_s"].read(ctx) == 7.5
    assert m["wire_mb_per_round"].read(ctx) == pytest.approx(900 / 3 / 1e6)
    assert m["peak_mem_gib.llama"].read(ctx) == 2.0
    traced = {"traced": {"t0": 10.0, "t1": 12.0, "rounds": 2}, "platform": "gpu",
              "kernels": [["alice", "k", 10.0, 0.5], ["bob", "k", 10.25, 0.5], ["bob", "k", 11.5, 1.0]]}
    assert m["device_idle.resnet"].read(traced) == pytest.approx(100 * (1 - 1.25 / 2))


def test_every_metric_reader_declares_itself():
    kinds = {spec.load_json("configs", c)["kind"] for c in spec.names("configs")}
    for name, reader in spec.metrics().items():
        assert reader.TRACE in (0, 1) and reader.UNIT, name
        if reader.TRACE:
            assert reader.LAYER and reader.MOVES, name
        assert getattr(reader, "KIND", None) in kinds | {None}, name


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_imports():
    """No module imports JAX or the JAX package; only the party driver imports
    the program (and the tests that hold the references against it).
    Compared by whole top-level name."""
    for path in sorted((ROOT / "fedbench").rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path
        if "rayfed_tpu_torch" in tops:
            assert path.parent.name in ("party", "tests"), path


def test_benchmark_json_matches_the_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    readers = spec.metrics()
    layers = {}
    for cell in bench["workloads"]:
        wl, cfg = spec.cell(cell["name"])
        assert wl["config"] == cell["config"] and wl["chips"] == cell["chips"] and wl["why"] == cell["why"]
        assert wl["follow_steps"] <= wl["local_steps"] and wl["warmup_rounds"] >= 2
        assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    for c in bench["configs"]:
        cfg = spec.load_json("configs", c["name"])
        assert c["file"] == f"fedbench/configs/{c['name']}.json" and c["source"] == cfg["source"]
        assert c["reduced"] == cfg["reduced"] and len(c["source"]) <= 200 and len(c["why"]) <= 200
    for m in bench["end_to_end"]:
        assert readers[m["name"]].TRACE == 0 and readers[m["name"]].UNIT == m["unit"]
    for m in bench["per_layer"]:
        r = readers[m["name"]]
        assert r.TRACE == 1 and r.UNIT == m["unit"] and r.MOVES == m["moves"] and r.LAYER == m["layer"]
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(readers) == {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    # A run reports a reader in the cells of its KIND (all cells without
    # one): exactly the metrics BENCHMARK.json gives each cell.  A per-layer
    # metric without a workloads key belongs to the cells that report the
    # metric it moves; one with the key, to those, which report it too.
    for cell in bench["workloads"]:
        kind = spec.cell(cell["name"])[1]["kind"]
        e2e = {m["name"] for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])}
        per_layer = {m["name"] for m in bench["per_layer"]
                     if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in e2e)}
        assert all(m["moves"] in e2e for m in bench["per_layer"] if m["name"] in per_layer)
        for trace, listed in ((0, e2e), (1, per_layer)):
            run = {n for n, r in readers.items() if r.TRACE == trace and getattr(r, "KIND", kind) == kind}
            assert listed == run, (cell["name"], listed ^ run)


def test_fp8_base_round_trip():
    """The control's base: each value on float8 e4m3's grid at a power-of-two
    scale a (layer, output channel), exact in bfloat16, within e4m3's half
    step of the original."""
    gen = torch.Generator().manual_seed(5)
    w = (torch.randn(3, 64, 40, generator=gen) * torch.rand(1, 1, 40, generator=gen) * 4).to(torch.bfloat16)
    before = w.float().clone()
    llama_ref.fp8_round_trip_(w, batch_axes=1)
    amax = before.abs().amax(dim=-2, keepdim=True)
    scale = torch.exp2(torch.ceil(torch.log2(amax / llama_ref.FP8_MAX)))
    q = w.float() / scale
    assert q.abs().max() <= llama_ref.FP8_MAX
    assert torch.equal(q.to(torch.float8_e4m3fn).float(), q)
    rel = ((w.float() - before).abs() / before.abs().clamp_min(1e-30))[before.abs() > scale * 2.0**-6]
    assert 0 < rel.max() <= 2.0**-4 and rel.mean() > 2.0**-8


def test_judge_rule_and_gaps():
    ref = {"a": 0.0, "b": 2.0, "c": 4.0, "scale": 0.0, "tiny": 1e-4}
    assert judge.counted(ref) == {"b", "c"}
    assert judge.worst_leaf_gap({"b": 2.2, "c": 4.0}, ref, {"b", "c"}) == pytest.approx(0.2 / 3.0)
    ok, checks = judge.verdict({"x": 0.5, "y": 0}, {"x": 1.0, "y": 0})
    assert ok and checks["x"] == {"value": 0.5, "limit": 1.0}
    assert not judge.verdict({"x": float("nan")}, {"x": 1.0})[0]


# The plain references against the program's CPU path at tiny sizes.

TINY_LLAMA = {"hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4, "num_key_value_heads": 2,
              "num_hidden_layers": 2, "vocab_size": 64, "sliding_window": 8, "torch_dtype": "float32"}


def test_llama_reference_against_the_program():
    """Loss and LoRA gradients of one step: the port's make_lora_train_step
    (its CPU path, windowed flash attention's plain version) and the plain
    reference, on the same weights and rows."""
    from rayfed_tpu_torch.models import llama
    from rayfed_tpu_torch.ops.flash_attention import flash_attention

    from fedbench.party import llama as party_llama

    wl, config = spec.cell("mistral7b.lora_swa8k")
    config = {**config, **TINY_LLAMA}
    wl = {**wl, "seq_len": 24, "rows_per_party": 1}
    params = traffic.llama_weights(config, 9, "cpu", torch.float32)
    lora = traffic.lora_adapters(config, wl["lora"], 9, "cpu")
    lora["layers"]["wq"]["b"].normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
    ids = traffic.token_rows(config, wl, 9, 0, "cpu")[0]
    step = llama.make_lora_train_step(party_llama.port_config(config, wl), lr=1e-3, attn_fn=flash_attention)
    _new, opt, loss = step(lora, llama.init_adam(lora), params, ids)
    trained = [e[w].clone().requires_grad_(True) for e in lora["layers"].values() for w in ("a", "b")]
    mine = {"layers": {k: {"a": trained[2 * i], "b": trained[2 * i + 1], "scale": e["scale"]}
                       for i, (k, e) in enumerate(lora["layers"].items())}}
    ref_loss = llama_ref.loss_fn(params, mine, ids, config)
    grads = torch.autograd.grad(ref_loss, trained)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    got = [opt[1]["layers"][k][w] / 0.1 for k in lora["layers"] for w in ("a", "b")]  # m = 0.1 g
    for g, r in zip(got, grads):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-6)


def test_resnet_reference_against_the_program():
    from rayfed_tpu_torch.models import resnet

    from fedbench.party import resnet as party_resnet

    wl, config = spec.cell("resnet18.hub4_b64")
    config = {**config, "stage_sizes": [1, 1], "width": 8, "image_size": 8}
    wl = {**wl, "batch": 6, "images_per_party": 12}
    params, state = traffic.resnet_weights(config, 3, "cpu")
    params["head"]["kernel"].normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
    x, y = traffic.images(config, wl, 3, 0, "cpu")
    step = resnet.make_train_step(party_resnet.port_config(config, torch.float32), lr=0.05, momentum=0.9)
    _p, _s, opt, loss = step(params, state, resnet.init_opt_state(params), x[:6], y[:6])
    leaves = [v.clone().requires_grad_(True) for _k, v in judge.tree_leaves(params)]
    flat = dict(zip([k for k, _v in judge.tree_leaves(params)], leaves))
    mine = {}
    for k, v in flat.items():
        node = mine
        *head, last = k.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = v
    ref_loss = torch.nn.functional.cross_entropy(resnet_ref.forward(mine, x[:6], config), y[:6])
    grads = torch.autograd.grad(ref_loss, leaves)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    for (k, g), r in zip(judge.tree_leaves(opt), grads):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-5, msg=k)


def test_fold_reference_against_the_program():
    """The plain fold and the port's fold (its CPU form of fold_fma.cu's chain)
    agree bit for bit, subnormals and all."""
    from rayfed_tpu_torch.ops import fold

    gen = torch.Generator().manual_seed(4)
    xs = [(torch.randn(4099, generator=gen) * 10.0 ** torch.randint(-40, 3, (4099,), generator=gen)).to(torch.bfloat16)
          for _ in range(4)]
    want = fold.fold_chain(xs, [1.0] * 4, 4.0, torch.bfloat16)
    assert torch.equal(fold_mean.fold(xs).view(torch.int16), want.view(torch.int16))


def test_attributed_shares_add_up_to_the_union():
    ks = [["a", 0.0, 2.0], ["b", 1.0, 2.0], ["c", 5.0, 1.0], ["d", 1.5, 0.5]]
    shares = devtrace.attributed(ks)
    assert shares == pytest.approx([1.0 + 0.25 + 0.5 / 3, 0.25 + 0.5 / 3 + 1.0, 1.0, 0.5 / 3])
    assert sum(shares) == pytest.approx(sum(e - s for s, e in devtrace.union(((k[1], k[1] + k[2]) for k in ks), 0, 9)))
