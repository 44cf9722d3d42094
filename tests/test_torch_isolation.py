"""The port stands alone: it imports neither JAX nor the reference package,
picks the card unless told otherwise, and differentiates flash attention
through its own backward.  The one place it names the reference package is
the wire name of the skeleton classes, a string constant."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rayfed_tpu_torch.ops.attention import dot_product_attention
from rayfed_tpu_torch.ops.flash_attention import flash_attention
from rayfed_tpu_torch.utils import platform

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "rayfed_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
              + sorted((ROOT / "examples_torch").glob("*.py")))

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "rayfed_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import rayfed_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rayfed_tpu_torch.__path__, "rayfed_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its import graph; the phases run only under __main__
import bench_torch  # likewise: the legs run only when called
import examples_torch
for ex in pkgutil.iter_modules(examples_torch.__path__, "examples_torch."):
    importlib.import_module(ex.name)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rayfed_tpu")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_with_jax_and_reference_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 71  # every module was walked


_BLOCKED_TRANSFORMERS = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("transformers", "jax", "jaxlib", "rayfed_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import rayfed_tpu_torch.models.hf, rayfed_tpu_torch.models.bert, rayfed_tpu_torch.fl.split
bad = [m for m in sys.modules if m.split(".")[0] in ("transformers", "jax", "jaxlib", "rayfed_tpu")]
assert not bad, bad
"""


def test_bert_split_and_hf_import_no_jax_and_hf_no_transformers():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_TRANSFORMERS],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    text = (ROOT / "rayfed_tpu_torch" / "models" / "hf.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(transformers|numpy)\b", text, re.M)


# The wire names of the skeleton, packed, quantized, hierarchy, server-opt
# state and masked-code classes: the only lines of the port that may name the reference
# package (rayfed_tpu_torch/serialization.py).
# The jaxlib/jax names a pickled tree structure carries ("jaxlib._jax.pytree",
# "jax._src.tree_util") are string constants there too, never imports.
WIRE_NAME_FILE = ROOT / "rayfed_tpu_torch" / "serialization.py"
WIRE_NAME_LINES = [
    'SKELETON_WIRE_MODULE = "rayfed_tpu.transport.wire"',
    'PACKED_WIRE_MODULE = "rayfed_tpu.fl.compression"',
    'QUANT_WIRE_MODULE = "rayfed_tpu.fl.quantize"',
    'HIERARCHY_WIRE_MODULE = "rayfed_tpu.fl.hierarchy"',
    'SERVER_OPT_WIRE_MODULE = "rayfed_tpu.fl.server_opt"',
    'SECAGG_WIRE_MODULE = "rayfed_tpu.fl.secagg"',
]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports_in_source(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib)\b", text, re.M)
    # "rayfed_tpu." and "from/import rayfed_tpu" name the reference; the
    # port's own name "rayfed_tpu_torch" shares the prefix and is allowed.
    naming = [line.strip() for line in text.splitlines() if re.search(r"\brayfed_tpu\.", line)]
    allowed = WIRE_NAME_LINES if path == WIRE_NAME_FILE else []
    assert naming == allowed
    assert not re.search(r"\b(from|import)\s+rayfed_tpu\b(?!_)", text)


def test_wire_name_is_the_reference_module():
    from rayfed_tpu_torch import serialization
    from rayfed_tpu_torch.fl import compression
    from rayfed_tpu_torch.transport import wire

    module, names = serialization.SKELETON_WIRE_MODULE, serialization._SKELETON_NAMES
    assert module.replace("rayfed_tpu", "rayfed_tpu_torch", 1) == wire.__name__
    assert {wire._Skeleton.__qualname__, wire._LeafSlot.__qualname__} == set(names)
    module, names = serialization.PACKED_WIRE_MODULE, serialization._PACKED_NAMES
    assert module.replace("rayfed_tpu", "rayfed_tpu_torch", 1) == compression.__name__
    assert {compression.PackedTree.__qualname__, compression.PackSpec.__qualname__} == set(names)
    from rayfed_tpu_torch.fl import quantize

    module, names = serialization.QUANT_WIRE_MODULE, serialization._QUANT_NAMES
    assert module.replace("rayfed_tpu", "rayfed_tpu_torch", 1) == quantize.__name__
    assert {quantize.QuantizedPackedTree.__qualname__, quantize.QuantMeta.__qualname__} == set(names)
    from rayfed_tpu_torch.fl import hierarchy

    module, names = serialization.HIERARCHY_WIRE_MODULE, serialization._HIERARCHY_NAMES
    assert module.replace("rayfed_tpu", "rayfed_tpu_torch", 1) == hierarchy.__name__
    assert {hierarchy.RegionSumTree.__qualname__} == set(names)
    from rayfed_tpu_torch.fl import server_opt

    module, names = serialization.SERVER_OPT_WIRE_MODULE, serialization._SERVER_OPT_NAMES
    assert module.replace("rayfed_tpu", "rayfed_tpu_torch", 1) == server_opt.__name__
    assert {server_opt.PackedServerState.__qualname__} == set(names)
    from rayfed_tpu_torch.fl import secagg

    module, names = serialization.SECAGG_WIRE_MODULE, serialization._SECAGG_NAMES
    assert module.replace("rayfed_tpu", "rayfed_tpu_torch", 1) == secagg.__name__
    assert {secagg.MaskedCodeTree.__qualname__} == set(names)
    text = WIRE_NAME_FILE.read_text()
    assert '"jaxlib._jax.pytree"' in text and '"jax._src.tree_util"' in text


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        platform.resolve_device()
    assert platform.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from rayfed_tpu_torch.models import llama, lora
    from rayfed_tpu_torch.models import bert
    from rayfed_tpu_torch.models.convert import (
        adam_from_jax,
        bert_params_from_jax,
        llama_params_from_jax,
        lora_from_jax,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.llama_tiny()
    with pytest.raises(RuntimeError):
        llama.init_llama(cfg, torch.Generator())
    with pytest.raises(RuntimeError):
        llama.init_kv_cache(cfg, 1, 8)
    params = llama.init_llama(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError):
        lora.init_lora(params, lora.LoraConfig(), torch.Generator())
    for convert in (llama_params_from_jax, lora_from_jax, adam_from_jax, bert_params_from_jax):
        with pytest.raises(RuntimeError):
            convert({})
    with pytest.raises(RuntimeError):
        bert.init_bert(bert.BertConfig(num_layers=1), torch.Generator())
    assert bert.init_bert(bert.BertConfig(num_layers=1), torch.Generator(),
                          device="cpu")["pooler"]["kernel"].device.type == "cpu"
    assert llama.init_kv_cache(cfg, 1, 8, device="cpu")["k"].device.type == "cpu"
    adapters = lora.init_lora(params, lora.LoraConfig(), torch.Generator(), device="cpu")
    assert adapters["layers"]["wq"]["a"].device.type == "cpu"

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.runtime import get_runtime_or_none

    cluster = {"solo": {"address": "127.0.0.1:1"}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fed.init(address="local", cluster=cluster, party="solo")
    assert get_runtime_or_none() is None  # raised before starting anything


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_attention_refuses_inputs_needing_grad(which):
    """The gradient of each input flows through the flash backward (on the
    CPU its plain version) and matches the dense path's."""
    rng = torch.Generator().manual_seed(which)
    qkv = [torch.randn(1, 8, 2, 8, generator=rng) for _ in range(3)]
    w = torch.randn(1, 8, 2, 8, generator=rng)
    grads = []
    for fn in (flash_attention, dot_product_attention):
        args = [x.clone() for x in qkv]
        args[which].requires_grad_(True)
        (fn(*args, causal=True) * w).sum().backward()
        grads.append(args[which].grad)
    assert grads[0] is not None and grads[0].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-5)
