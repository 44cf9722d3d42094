"""``bench_torch.py --compute-only`` on the CPU: bench.py's compute section
(llama_train with its MFU breakdown, decode, flash, lora_8b, moe) at a tiny
size in this process, its work counts against the reference's, and the
command line.  The key sets and the reference's formulas are read from
``bench.py``'s source."""

import ast
import dataclasses
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import bench_torch
import chip_smoke
from rayfed_tpu.models import llama as jllama
from rayfed_tpu_torch.models import llama, lora, moe

# The module (the package's ``flash_attention`` is the function).
flash_mod = importlib.import_module("rayfed_tpu_torch.ops.flash_attention")

ROOT = Path(__file__).resolve().parents[1]
_TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, intermediate_size=128,
             max_seq_len=64, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
# Each leg at 2 layers and narrow widths, a few steps; the counts are wide
# enough apart that a slope stays positive on a busy host.
TINY_KW = {
    "llama_train": dict(cfg=llama.LlamaConfig(**_TINY, remat=True, remat_policy="dots"), batch=1, seq=32,
                        n_short=1, n_long=6, probe_n={k: (2, 22) for k in bench_torch.PROBE_N}),
    "decode": dict(cfg=llama.LlamaConfig(**_TINY), batch=2, t0=8, n_short=2, n_long=14, t0_long=16,
                   n_short_long=2, n_long_long=12, reps=3),
    "flash": dict(heads=2, head_dim=16, batch=1, seq=64, batch_long=1, seq_long=128, n_short=2, n_long=22,
                  n_long_t4096=22, window=32, reps=3),
    "lora_8b": dict(cfg=llama.LlamaConfig(**_TINY, remat=True), batch=1, seq=32, rank=4, n_short=1, n_long=6,
                    decode_batch=2, prompt_len=8, decode_short=2, decode_long=12, reps=3),
    "moe": dict(cfg=moe.MoeConfig(num_experts=4, top_k=2, d_model=32, d_ff=64), batch=1, seq=128, n_short=2,
                n_long=22, reps=3),
}


def _may_be_zero(key):
    """A share or a size, rounded to the reference's precision, which at this
    size can round to 0 (``chip_smoke.py``'s phase_bench_compute holds every
    key positive at the card's sizes but the residual ``llama_other_ms``),
    or a probe line the reference clamps at 0.  Every time, rate and speedup must be positive here too."""
    return key.endswith(("_mfu", "_membw_util", "_frac", "_params_b", "_base_gb")) or key in (
        "llama_other_ms", "llama_remat_ms")


def _bench_tree():
    return ast.parse((ROOT / "bench.py").read_text())


def _functions(tree):
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _keys_of(funcs, name):
    """The string keys a bench.py function returns: its returned dict, its
    ``out = {...}``, the keywords of its ``out.update(...)`` and the keys of
    any bench.py function whose result it passes to ``out.update``."""
    keys = set()
    for node in ast.walk(funcs[name]):
        value = None
        if isinstance(node, ast.Return):
            value = node.value
        elif isinstance(node, ast.Assign) and [getattr(t, "id", None) for t in node.targets] == ["out"]:
            value = node.value
        if isinstance(value, ast.Dict):
            keys |= {k.value for k in value.keys if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "update"
                and getattr(node.func.value, "id", None) == "out"):
            keys |= {kw.arg for kw in node.keywords}
            for arg in node.args:
                if isinstance(arg, ast.Call) and getattr(arg.func, "id", None) in funcs:
                    keys |= _keys_of(funcs, arg.func.id)
    return keys


def _reference_compute_legs():
    """``{section: keys}`` of ``main``'s compute section, in its order: each
    ``with _section(extra, name): extra.update(bench_*())``."""
    funcs = _functions(_bench_tree())
    legs = {}
    for node in ast.walk(funcs["main"]):
        if not isinstance(node, ast.With):
            continue
        call = node.items[0].context_expr
        if getattr(call.func, "id", None) != "_section":
            continue
        for stmt in ast.walk(node):
            if (isinstance(stmt, ast.Call) and isinstance(stmt.func, ast.Attribute) and stmt.func.attr == "update"
                    and stmt.args and isinstance(stmt.args[0], ast.Call)
                    and getattr(stmt.args[0].func, "id", "").startswith("bench_")):
                legs[call.args[1].value] = _keys_of(funcs, stmt.args[0].func.id)
    return legs


def _reference_expr(function, target):
    """The expression bench.py's ``function`` assigns to ``target``, compiled."""
    for node in ast.walk(_functions(_bench_tree())[function]):
        if isinstance(node, ast.Assign) and [getattr(t, "id", None) for t in node.targets] == [target]:
            return compile(ast.Expression(node.value), f"bench.py:{function}", "eval")
    raise AssertionError(f"{function} assigns no {target}")


_LINE = {"metric", "value", "unit", "vs_baseline", "env_cpu_count", "env_loadavg_1m", "env_platform",
         "env_device_kind"}


@pytest.fixture(scope="module")
def tiny_runs():
    """``{leg: (record, stats)}``: each leg alone through ``run_compute``, on
    one thread (tiny ops gain nothing from more, and the tier-1 workers
    share the host's cores)."""
    runs, threads = {}, torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for leg in bench_torch.COMPUTE_LEG_NAMES:
            stats = {}
            record = bench_torch.run_compute("cpu", stats, legs=(leg,), leg_kw=TINY_KW)
            runs[leg] = (record, stats[leg])
    finally:
        torch.set_num_threads(threads)
    return runs


def test_compute_legs_are_the_reference_sections_in_order():
    assert tuple(_reference_compute_legs()) == bench_torch.COMPUTE_LEG_NAMES


@pytest.mark.parametrize("leg", bench_torch.COMPUTE_LEG_NAMES)
def test_leg_returns_the_reference_keys(tiny_runs, leg):
    record, stats = tiny_runs[leg]
    assert f"{leg}_error" not in record, record.get(f"{leg}_error")
    want = _reference_compute_legs()[leg]
    assert set(record) - _LINE == want
    for key in want:
        value = record[key]
        assert isinstance(value, (int, float)) and math.isfinite(value) and value >= 0, (key, value)
        if not _may_be_zero(key):
            assert value > 0, (key, value)
    assert stats["s"] > 0 and stats["peak_bytes"] is None
    # The CPU runs the kernels' plain versions: no launch.
    assert not any(stats["launches"].values())


def test_record_is_the_reference_line(tiny_runs):
    record, _ = tiny_runs["llama_train"]
    assert set(record) >= _LINE
    assert record["metric"] == "llama_tokens_per_sec" and record["unit"] == "tokens/s"
    assert record["value"] == record["llama_tokens_per_sec"] and record["vs_baseline"] == 1.0
    assert record["env_device_kind"] == "cpu"
    # Without the llama leg the headline is the reference's fallback.
    assert tiny_runs["moe"][0]["value"] == 0.0


def test_train_legs_record_their_steps(tiny_runs):
    for leg in ("llama_train", "lora_8b"):
        stats, kw = tiny_runs[leg][1], TINY_KW[leg]
        assert stats["train_steps"] == 2 * (kw["n_short"] + kw["n_long"])  # each length warm, then timed
        assert stats["train_launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def _jax_bench_config(**kw):
    return jllama.LlamaConfig(vocab_size=16384, hidden_size=2048, num_layers=16, num_heads=16, num_kv_heads=8,
                              intermediate_size=8192, max_seq_len=2048, dtype=jnp.bfloat16,
                              param_dtype=jnp.bfloat16, **kw)


_CONFIGS = {
    "llama_1b": (lambda: bench_torch._bench_llama_config(), lambda: _jax_bench_config()),
    "llama3_8b": (lambda: llama.llama3_8b(max_seq_len=2048, param_dtype=torch.bfloat16),
                  lambda: jllama.llama3_8b(max_seq_len=2048, param_dtype=jnp.bfloat16)),
}


@pytest.mark.parametrize("name", list(_CONFIGS))
@pytest.mark.parametrize("exclude_embed", [False, True])
def test_param_count_on_meta_equals_the_references(name, exclude_embed):
    port_cfg, jax_cfg = (f() for f in _CONFIGS[name])
    abstract = jax.eval_shape(lambda: jllama.init_llama(jax.random.PRNGKey(0), jax_cfg))
    meta = bench_torch._meta_params(port_cfg)
    assert all(t.device.type == "meta" for t in torch.utils._pytree.tree_leaves(meta))
    assert llama.param_count(meta, exclude_embed=exclude_embed) == jllama.param_count(
        abstract, exclude_embed=exclude_embed)


def test_step_flops_equal_the_references():
    cfg = bench_torch._bench_llama_config(remat=True, remat_policy="dots")
    n_matmul = llama.param_count(bench_torch._meta_params(cfg), exclude_embed=True)
    batch, seq = 2, 2048
    ref = eval(_reference_expr("bench_llama", "flops_per_step"),
               {"n_matmul": n_matmul, "tokens": batch * seq, "cfg": cfg, "batch": batch, "seq": seq})
    assert bench_torch._llama_step_flops(cfg, batch, seq, n_matmul) == ref
    assert ref == 6 * 1_040_254_976 * 4096 + 6 * 16 * 2 * 2048**2 * 2048


@pytest.mark.parametrize("batch,seq", [(2, 2048), (1, 16)])
def test_layer_matmul_flops_equal_the_references(batch, seq):
    cfg = bench_torch._bench_llama_config()
    dh = cfg.head_dim
    names = {"D": cfg.hidden_size, "H": cfg.num_heads, "Dh": dh, "kv_dim": cfg.num_kv_heads * dh,
             "F": cfg.intermediate_size, "B": batch, "T": seq}
    ref = eval(_reference_expr("_llama_mfu_breakdown", "layer_matmul_flops"), names)
    assert bench_torch._layer_matmul_flops(cfg, batch, seq) == ref


@pytest.mark.parametrize("name", list(_CONFIGS))
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("batch,eff_len", [(8, 399.5), (4, 271.5), (8, 1687.5)])
def test_kv_cache_bytes_equal_the_references(name, kv_quant, batch, eff_len):
    import bench

    port_cfg, jax_cfg = (f() for f in _CONFIGS[name])
    port_cfg = dataclasses.replace(port_cfg, kv_quant=kv_quant)
    jax_cfg = dataclasses.replace(jax_cfg, kv_quant=kv_quant)
    assert bench_torch._kv_cache_bytes(port_cfg, batch, eff_len) == bench._kv_cache_bytes(jax_cfg, batch, eff_len)


def _slots_read(monkeypatch, n_new, t0, cfg, params, prompt):
    """Cache slots the port's greedy_generate reads: the key extent of each
    decode step's score product, one per layer."""
    seen = []
    real = torch.einsum

    def spy(eq, *operands):
        if eq == "bngd,btnd->bngt":
            seen.append(operands[1].shape[1])
        return real(eq, *operands)

    monkeypatch.setattr(torch, "einsum", spy)
    try:
        out = llama.greedy_generate(params, cfg, prompt, n_new)
    finally:
        monkeypatch.setattr(torch, "einsum", real)
    assert out.shape == (prompt.shape[0], t0 + n_new)
    assert len(seen) == cfg.num_layers * (n_new - 1)  # no step for the last token
    return sum(seen) / cfg.num_layers


def test_live_eff_len_counts_the_slots_generate_reads(monkeypatch):
    import bench

    cfg = llama.llama_tiny()
    params = llama.init_llama(cfg, torch.Generator().manual_seed(0), device="cpu")
    t0, n_short, n_long = 8, 2, 6
    prompt = torch.randint(0, cfg.vocab_size, (2, t0), generator=torch.Generator().manual_seed(1))
    reads = {n: _slots_read(monkeypatch, n, t0, cfg, params, prompt) for n in (n_short, n_long)}
    counted = (reads[n_long] - reads[n_short]) / (n_long - n_short)
    assert bench_torch._live_eff_len(t0, n_short, n_long) == counted == t0 + (n_short + n_long - 1) / 2

    # The reference charges the whole padded buffer, t0 + n_new slots,
    # n_new times: (n_short + n_long + 1) / 2 slots a step more.
    jcfg = jllama.llama_tiny()
    jparams = jllama.init_llama(jax.random.PRNGKey(0), jcfg)
    jprompt = jax.random.randint(jax.random.PRNGKey(1), (2, t0), 0, jcfg.vocab_size)
    from rayfed_tpu.ops.attention import dot_product_attention

    _, ref_eff_len = bench._decode_slope(jcfg, jparams, jprompt, n_short, n_long, dot_product_attention, reps=1)
    assert ref_eff_len == t0 + n_short + n_long
    assert ref_eff_len - counted == (n_short + n_long + 1) / 2


def test_peak_lookup():
    assert bench_torch._peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert bench_torch._peak_hbm_bps("NVIDIA H100 80GB HBM3") == 3.35e12
    for fn in (bench_torch._peak_flops, bench_torch._peak_hbm_bps):
        with pytest.raises(RuntimeError, match="no published peak"):
            fn("NVIDIA A100-SXM4-80GB")
        with pytest.raises(RuntimeError, match="no published peak"):
            fn("NVIDIA H100 PCIe")
    assert bench_torch._peak_flops("cpu") == 1e12  # the reference's CPU figures
    assert bench_torch._peak_hbm_bps("cpu") == 100e9


def _count_flash_calls(monkeypatch):
    counts = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = flash_mod._flash_forward, flash_mod._flash_backward

    def fwd(*a, **kw):
        counts["fwd"] += 1
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        counts["bwd"] += 1
        return real_bwd(*a, **kw)

    monkeypatch.setattr(flash_mod, "_flash_forward", fwd)
    monkeypatch.setattr(flash_mod, "_flash_backward", bwd)
    return counts


@pytest.mark.parametrize("leg", ["llama_train", "lora_8b"])
def test_train_step_flash_calls_are_chip_smokes_count(monkeypatch, leg):
    """A train step of each leg's remat calls the flash forward twice a
    layer (the backward replays it) and the backward once: the launches
    phase_bench_compute holds the card to, a step."""
    cfg = TINY_KW[leg]["cfg"]
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen)
    params = llama.init_llama(cfg, gen, device="cpu")
    if leg == "llama_train":
        step = llama.make_train_step(cfg, attn_fn=flash_mod.flash_attention)
        args = (params, llama.init_adam(params), ids)
    else:
        adapters = lora.init_lora(params, lora.LoraConfig(rank=4), gen, device="cpu")
        step = llama.make_lora_train_step(cfg, attn_fn=flash_mod.flash_attention)
        args = (adapters, llama.init_adam(adapters), params, ids)
    counts = _count_flash_calls(monkeypatch)
    step(*args)
    want = chip_smoke._train_step_launches(cfg.num_layers)
    assert counts == {"fwd": want["flash_fwd"], "bwd": want["flash_bwd_dq"]}
    assert want["flash_bwd_dq"] == want["flash_bwd_dkv"] == cfg.num_layers


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run every leg on it")


def test_compute_only_without_a_card_fails_before_any_leg():
    _no_card()
    proc = subprocess.run([sys.executable, "bench_torch.py", "--compute-only"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not any(msg in proc.stderr for _, msg, _ in bench_torch.COMPUTE_LEGS)  # no leg started
    assert proc.stdout.strip() == ""  # no record


@pytest.mark.parametrize("argv", [["--fed-only"], []])
def test_federated_section_exits_2(argv, capsys, monkeypatch):
    """The federated section is ported (it exited 2 before): ``--fed-only``
    runs it alone, no mode flag runs it and then the compute section, each
    printing one record line with the federated headline and every leg's
    keys, and exiting 1 when a leg failed.  The sections are stubbed here:
    ``tests/test_torch_bench_fed_*.py`` run the legs."""
    calls = []

    def fed(device, **kw):
        calls.append(("fed", device))
        return {"metric": bench_torch.HEADLINE, "value": 1.5, "unit": "rounds/s", "vs_baseline": 1.0,
                "env_device_kind": "cpu", "push_GBps": 2.0}

    def compute(device, **kw):
        calls.append(("compute", device))
        return {"metric": "llama_tokens_per_sec", "value": 9.0, "unit": "tokens/s", "vs_baseline": 1.0,
                "env_device_kind": "cpu", "llama_mfu": 0.1}

    monkeypatch.setattr(bench_torch, "run_fed", fed)
    monkeypatch.setattr(bench_torch, "run_compute", compute)
    assert bench_torch.main([*argv, "--device", "cpu"]) == 0
    want = [("fed", "cpu")] + ([] if argv else [("compute", "cpu")])
    assert calls == want
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert record["metric"] == bench_torch.HEADLINE and record["push_GBps"] == 2.0
    assert ("llama_mfu" in record) == (not argv)
    monkeypatch.setattr(bench_torch, "run_fed", lambda device, **kw: {**fed(device), "split_fl_error": "x"})
    assert bench_torch.main([*argv, "--device", "cpu"]) == 1


def test_fed_only_and_compute_only_are_mutually_exclusive():
    with pytest.raises(SystemExit, match="mutually exclusive"):
        bench_torch.main(["--fed-only", "--compute-only", "--device", "cpu"])
