"""The Llama RMSNorm's kernels (``rayfed_tpu_torch/ops/rms_norm.py``,
``csrc/rms_norm.cu``) and the model's CPU form.

On the CPU: the model's norms keep XLA:CPU's bytes, take PyTorch's
gradient of the formula and launch no kernel; the kernels refuse what is
not on a card; a DTensor on the card runs the kernels on whole rows (a
split width or partial sums gathered first, the scale's gradient summed
over the ranks that split the rows), checked here in a world of two gloo
ranks with the kernels' call replaced by the formula.

On the card (``gpu``): the kernels against autograd of the formula at
Mistral's shape, a decode shape, the widths the registers do not hold,
every element type; the Function under checkpoint; a DTensor world of two
ranks on the card; a small Llama LoRA step on flash against the formula's
path, with the launches it takes.  Tolerances: the kernel sums each row in
another order than PyTorch (fma into one running sum a thread, then a
tree) and ``rsqrtf`` is within 2 ulps, so its ``y`` may differ from the
formula's by one step of its type plus 4 f32 ulps where ``r`` moved, and
its gradients by one step plus 1e-4 of the largest (sums over 4096
columns and up to 8192 rows).

This file imports no JAX, so on the machine with the card its ``gpu`` tests
run without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_rms_norm.py
"""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from rayfed_tpu_torch.models import llama, lora
from rayfed_tpu_torch.ops import rms_norm as rn
from rayfed_tpu_torch.ops import xla_cpu
from rayfed_tpu_torch.parallel.launch import run_world

EPS = 1e-5
ULP = {torch.float32: 2.0**-23, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}  # a step, relative
DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)]
PAIR_IDS = ["f32", "bf16", "bf16-f32scale"]
# A DTensor x's placements on a mesh of two ranks, and the placements of the
# norm's output: rows split stay split; a split width and partial sums are
# gathered.
PLACEMENTS = {"rows": ("shard1", "shard1"), "width": ("shard2", "replicate"),
              "partial": ("partial", "replicate"), "replicate": ("replicate", "replicate")}


def _inputs(shape, dtype, scale_dtype, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 3.0).to(dtype)
    scale = (1.0 + 0.5 * torch.randn(shape[-1], generator=gen)).to(scale_dtype)
    dy = torch.randn(shape, generator=gen).to(dtype)
    return x.to(device), scale.to(device), dy.to(device)


def _autograd(x, scale, dy, scale_grad, norm=rn.rms_norm_plain):
    x = x.detach().requires_grad_(True)
    scale = scale.detach().requires_grad_(scale_grad)
    y = norm(x, scale, EPS)
    wrt = (x, scale) if scale_grad else (x,)
    grads = torch.autograd.grad(y, wrt, dy)
    return y.detach(), grads[0], grads[1] if scale_grad else None


def _counts():
    return rn.rms_norm.fwd_launches, rn.rms_norm.bwd_launches, rn.rms_norm.dscale_launches


@pytest.fixture(autouse=True)
def _zero_counts():
    rn.reset_launches()
    yield
    rn.reset_launches()


def _tiny(remat, policy, dtype=torch.float32):
    cfg = llama.llama_tiny(remat=remat, remat_policy=policy, dtype=dtype)
    params = llama.init_llama(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    for name in ("attn_norm", "mlp_norm"):
        params["layers"][name] = 1.0 + 0.3 * torch.randn(params["layers"][name].shape, generator=gen)
    params["final_norm"] = 1.0 + 0.3 * torch.randn(params["final_norm"].shape, generator=gen)
    adapters = lora.init_lora(params, lora.LoraConfig(rank=4), torch.Generator().manual_seed(2), device="cpu")
    for entry in adapters["layers"].values():
        entry["b"] = 0.05 * torch.randn(entry["b"].shape, generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    return cfg, params, adapters, ids


# ---------------------------------------------------------------------- CPU


@pytest.mark.parametrize("jitted", [False, True])
def test_cpu_norms_keep_xla_bytes_and_launch_nothing(jitted):
    for dtypes, width in ((DTYPE_PAIRS[0], 64), (DTYPE_PAIRS[1], 4096), (DTYPE_PAIRS[2], 64)):
        x, scale, _ = _inputs((2, 3, width), *dtypes)
        out = llama._rms_norm(x, scale, EPS, jitted)
        want = xla_cpu.rms_norm(x, scale, EPS, jitted)
        assert out.dtype == want.dtype and torch.equal(out.view(torch.uint8), want.view(torch.uint8))
    cfg, params, adapters, ids = _tiny(True, None)
    llama._value_and_grad(llama._lora_loss(cfg, llama.dot_product_attention), adapters, params, ids)
    assert _counts() == (0, 0, 0)


@pytest.mark.parametrize("scale_grad", [False, True], ids=["frozen", "dscale"])
@pytest.mark.parametrize("dtypes", DTYPE_PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("width", [64, 4096])
def test_cpu_gradients_are_pytorchs_of_the_formula(width, dtypes, scale_grad):
    """The model's CPU norm takes XLA's value and PyTorch's gradient of the
    formula the kernels are held to, bit for bit."""
    x, scale, dy = _inputs((3, 5, width), *dtypes)
    _, want_dx, want_ds = _autograd(x, scale, dy, scale_grad)
    _, dx, ds = _autograd(x, scale, dy, scale_grad, norm=llama._rms_norm)
    assert torch.equal(dx, want_dx)
    assert (ds is None) == (not scale_grad) and (ds is None or torch.equal(ds, want_ds))


@pytest.mark.parametrize("remat,policy", [(False, None), (True, None), (True, "dots")],
                         ids=["no-remat", "remat", "remat-dots"])
def test_cpu_model_gradients_do_not_depend_on_remat(remat, policy):
    """The tiny Llama's LoRA and full-parameter gradients through its CPU
    norms: the same with and without remat (and the "dots" policy), bit for
    bit, with no launch."""
    def run(remat, policy):
        cfg, params, adapters, ids = _tiny(remat, policy)
        return (llama._value_and_grad(llama._lora_loss(cfg, llama.dot_product_attention), adapters, params, ids),
                llama._value_and_grad(llama._full_loss(cfg, llama.dot_product_attention), params, ids))

    for (loss, grads), (loss_b, grads_b) in zip(run(remat, policy), run(False, None)):
        assert torch.equal(loss, loss_b)
        for g, g_b in zip(torch.utils._pytree.tree_leaves(grads), torch.utils._pytree.tree_leaves(grads_b)):
            assert torch.equal(g, g_b)
    assert _counts() == (0, 0, 0)


def test_the_kernels_refuse_what_is_not_on_a_card():
    x, scale, _ = _inputs((2, 64), torch.float32, torch.float32)
    assert not rn.takes_kernel(x, scale)  # a CPU tensor
    meta = torch.empty((4, 4096), dtype=torch.bfloat16, device="meta")
    assert not rn.takes_kernel(meta, torch.empty(4096, device="meta"))
    for args in ((x, scale), (meta, torch.empty(4096, device="meta"))):
        with pytest.raises(ValueError, match="on a CUDA card"):
            rn.rms_norm(*args, EPS)
    assert _counts() == (0, 0, 0)


def test_dtensors_on_the_cpu_take_pytorch_ops():
    """A CPU DTensor (here on a one-rank gloo mesh) runs the formula as
    PyTorch ops: it holds no storage for XLA:CPU's form to read."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    x, scale, _ = _inputs((2, 3, 64), torch.float32, torch.float32)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0])
        xd, sd = (distribute_tensor(t, mesh, [Replicate()]) for t in (x, scale))
        out = llama._rms_norm(xd, sd, EPS)
        assert llama._sharded(out)
        assert torch.equal(out.full_tensor(), rn.rms_norm_plain(x, scale, EPS))
    finally:
        dist.destroy_process_group()
    assert _counts() == (0, 0, 0)


def _placement(name):
    from torch.distributed.tensor import Partial, Replicate, Shard

    return {"shard1": Shard(1), "shard2": Shard(2), "partial": Partial(), "replicate": Replicate()}[name]


def dtensor_ranks(rank, dev, arrays, stand_in):
    """Each case of PLACEMENTS on a mesh of the world's ranks: ``x`` placed
    so, the scale replicated, both needing a gradient, through
    ``rms_norm.rms_norm``; with ``stand_in`` the kernels' call on a rank's
    whole rows is the formula (autograd's gradient), for a CPU world.
    Returns each case's output placements and the gathered y, dx, dscale."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from rayfed_tpu_torch.parallel.mesh import create_mesh

    if stand_in:
        rn._local = rn.rms_norm_plain
    mesh = create_mesh({"a": 2}, device=dev.type)
    x, scale, dy = (torch.from_numpy(a).to(dev) for a in arrays)
    out = {}
    for case, (placed, _) in PLACEMENTS.items():
        p = _placement(placed)
        if placed == "partial":  # each rank holds half of x: the sum is x, exactly
            xd = DTensor.from_local(x / 2, mesh, [p], run_check=False)
        else:
            xd = distribute_tensor(x, mesh, [p])
        xd = xd.detach().requires_grad_(True)
        sd = distribute_tensor(scale, mesh, [Replicate()]).detach().requires_grad_(True)
        y = rn.rms_norm(xd, sd, EPS)
        dyd = distribute_tensor(dy, mesh, list(y.placements))
        dx, ds = torch.autograd.grad(y, (xd, sd), dyd)
        out[case] = {"placements": [str(q) for q in y.placements],
                     **{k: t.full_tensor().detach().cpu().numpy() for k, t in (("y", y), ("dx", dx), ("ds", ds))}}
    out["launches"] = _counts()
    return out


def _dtensor_world(device):
    x, scale, dy = _inputs((2, 8, 64), torch.float32, torch.float32)
    arrays = tuple(t.numpy() for t in (x, scale, dy))
    stand_in = device == "cpu"
    return (x, scale, dy), run_world(dtensor_ranks, 2, (arrays, stand_in), device=device, timeout_s=240)


def _check_dtensor_case(world, case, atol):
    (x, scale, dy), ranks = world
    want_y, want_dx, want_ds = (t.numpy() for t in _autograd(x, scale, dy, True))
    _, want_placement = PLACEMENTS[case]
    for res in ranks:
        got = res[case]
        assert got["placements"] == [str(_placement(want_placement))]
        np.testing.assert_allclose(got["y"], want_y, rtol=atol, atol=atol)
        np.testing.assert_allclose(got["dx"], want_dx, rtol=atol, atol=atol)
        # Each rank's dscale covers its own rows where they are split: the
        # sum over both is the whole (in another order: f32 rounding).
        np.testing.assert_allclose(got["ds"], want_ds, rtol=1e-5, atol=1e-5 * np.abs(want_ds).max())


@pytest.fixture(scope="module")
def cpu_world():
    return _dtensor_world("cpu")


@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_dtensor_norm_runs_on_whole_rows(cpu_world, case):
    _check_dtensor_case(cpu_world, case, atol=1e-6)
    assert all(res["launches"] == (0, 0, 0) for res in cpu_world[1])


# --------------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_routing_on_the_card(cuda):
    bf = torch.bfloat16
    ok = torch.empty((4, 4096), dtype=bf, device=cuda)
    for scale_dtype in (bf, torch.float32, torch.float16):
        assert rn.takes_kernel(ok, torch.empty(4096, dtype=scale_dtype, device=cuda))
    assert rn.takes_kernel(ok.half(), torch.empty(4096, dtype=bf, device=cuda))
    assert rn.takes_kernel(torch.empty((4, 4100), dtype=bf, device=cuda), torch.empty(4100, dtype=bf, device=cuda))
    assert not rn.takes_kernel(ok.double(), torch.empty(4096, dtype=bf, device=cuda))  # f64
    assert not rn.takes_kernel(ok, torch.empty(4096, dtype=bf))  # scale off the card
    assert not rn.takes_kernel(ok, torch.empty(4092, dtype=bf, device=cuda))  # scale of another width
    with pytest.raises(ValueError, match="on a CUDA card"):
        llama._rms_norm(ok.double(), torch.empty(4096, dtype=torch.float64, device=cuda), EPS)


def _card_case(cuda, shape, dtype, scale_dtype, scale_grad, seed=0, offset=0):
    x, scale, dy = _inputs(shape, dtype, scale_dtype, device=cuda, seed=seed)
    if offset:  # a contiguous x from an address off 16 bytes
        flat = torch.empty(x.numel() + offset, dtype=dtype, device=cuda)
        flat[offset:] = x.reshape(-1)
        x = flat[offset:].view(shape)
        assert x.is_contiguous() and x.data_ptr() % 16
    want_y, want_dx, want_ds = _autograd(x, scale, dy, scale_grad)
    xg = x.detach().requires_grad_(True)
    sg = scale.clone().requires_grad_(scale_grad)
    before = _counts()
    y = rn.rms_norm(xg, sg, EPS)
    grads = torch.autograd.grad(y, (xg, sg) if scale_grad else (xg,), dy)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + int(scale_grad))
    # y: within one step of its type of the formula's, plus 4 f32 ulps (r may
    # move by the f32 sum's order and rsqrtf's 2 ulps, and y's products round it).
    step = (ULP[dtype] + 4 * ULP[torch.float32]) * want_y.float().abs()
    assert ((y.float() - want_y.float()).abs() <= step).all()
    # dx, dscale: the f32 sums in the kernel's order, 1e-4 of the largest plus one step.
    for got, want, dt in ((grads[0], want_dx, dtype),) + (((grads[1], want_ds, scale_dtype),) if scale_grad else ()):
        assert got.dtype == dt
        err = (got.float() - want.float()).abs() - ULP[dt] * want.float().abs()
        assert err.max().item() <= 1e-4 * want.float().abs().max().item()
    return y


F16 = (torch.float16, torch.float16)
F16_BF = (torch.float16, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("scale_grad", [False, True], ids=["frozen", "dscale"])
@pytest.mark.parametrize("shape,dtypes", [((8192, 4096), DTYPE_PAIRS[1]), ((4, 1, 4096), DTYPE_PAIRS[1]),
                                          ((1000, 64), DTYPE_PAIRS[0]), ((37, 4096), DTYPE_PAIRS[2]),
                                          ((5, 8192), DTYPE_PAIRS[1]), ((9, 8192), DTYPE_PAIRS[0]),
                                          ((300, 4096), F16), ((64, 1024), F16_BF),
                                          ((300, 4100), DTYPE_PAIRS[1]), ((7, 1, 100), DTYPE_PAIRS[0]),
                                          ((3, 16384), DTYPE_PAIRS[1]), ((40, 12000), F16)],
                         ids=["mistral", "decode", "f32-64", "bf16-f32scale", "widest", "widest-f32", "f16",
                              "f16-bf16scale", "width-4100", "width-100", "width-16384", "f16-12000"])
def test_kernels_against_the_formula(cuda, shape, dtypes, scale_grad):
    _card_case(cuda, shape, *dtypes, scale_grad)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [4096, 4100])
def test_kernels_take_an_unaligned_view(cuda, width):
    _card_case(cuda, (33, width), torch.bfloat16, torch.bfloat16, True, offset=1)


@pytest.mark.gpu
def test_kernels_are_deterministic_and_serve_without_rstd(cuda):
    x, scale, dy = _inputs((3000, 4096), torch.bfloat16, torch.bfloat16, device=cuda)
    runs = []
    for _ in range(2):
        xg, sg = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
        y = rn.rms_norm(xg, sg, EPS)
        runs.append((y, *torch.autograd.grad(y, (xg, sg), dy)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    with torch.no_grad():
        y = rn.rms_norm(x, scale, EPS)
    y2, rstd = rn._forward(x, scale, EPS, want_rstd=False)
    assert rstd is None and torch.equal(y, runs[0][0]) and torch.equal(y2, y)
    assert _counts() == (4, 2, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", [None, "dots"])
def test_checkpoint_recomputes_the_same_gradients(cuda, policy):
    """Under non-reentrant checkpoint (with the model's selective policy for
    "dots") the Function is recomputed and gives the gradients of the run
    without checkpoint, bit for bit."""
    x, scale, dy = _inputs((2, 8, 64), torch.float32, torch.float32, device=cuda)
    w = (torch.randn(64, 64, generator=torch.Generator().manual_seed(1)) / 8).to(cuda)

    def body(x, scale):
        h = rn.rms_norm(x, scale, EPS) @ w
        return rn.rms_norm(h, scale, EPS)

    def grads(run):
        xg, sg = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
        return torch.autograd.grad(run(xg, sg), (xg, sg), dy)

    plain = grads(body)
    kw = dict(use_reentrant=False)
    if policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(llama._save_weight_products)
    remat = grads(lambda a, b: checkpoint(body, a, b, **kw))
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def card_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rayfed_tpu_torch.ops._build import rms_norm_lib

    rms_norm_lib()  # build once, before the ranks load it
    return _dtensor_world(None)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_dtensor_norm_on_the_card(card_world, case):
    """Two ranks sharing the card: each case through the kernels, a forward
    and a backward (with dscale) launch a case on each rank."""
    _check_dtensor_case(card_world, case, atol=1e-5)
    assert all(res["launches"] == (4, 4, 4) for res in card_world[1])


@pytest.mark.gpu
def test_lora_step_on_flash_against_the_formula(cuda, monkeypatch):
    """A small Llama's LoRA step (flash, remat, bf16): every norm on the
    kernels, 2·L + 1 forward launches a forward pass (twice under remat) and
    a backward launch for each norm whose input needs a gradient, no dscale;
    losses and adapter gradients within 2% of the largest gradient of the
    formula's path."""
    from rayfed_tpu_torch.ops.flash_attention import flash_attention

    layers = 4
    cfg = llama.llama_tiny(num_layers=layers, hidden_size=256, num_heads=2, num_kv_heads=1,
                           intermediate_size=512, vocab_size=512, dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16, remat=True, max_seq_len=512)
    params = llama.init_llama(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for name in ("attn_norm", "mlp_norm"):
        params["layers"][name] = (1.0 + 0.3 * torch.randn(params["layers"][name].shape, generator=gen,
                                                          device=cuda)).to(torch.bfloat16)
    adapters = lora.init_lora(params, lora.LoraConfig(rank=8), torch.Generator(device=cuda).manual_seed(2),
                              device=cuda)
    for entry in adapters["layers"].values():
        entry["b"] = 0.05 * torch.randn(entry["b"].shape, generator=gen, device=cuda)
    ids = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen, device=cuda)
    loss_fn = llama._lora_loss(cfg, flash_attention)

    with torch.no_grad():
        llama.apply_llama(params, ids, cfg, attn_fn=flash_attention)
    assert _counts() == (2 * layers + 1, 0, 0)
    rn.reset_launches()
    loss, grads = llama._value_and_grad(loss_fn, adapters, params, ids)
    torch.cuda.synchronize()
    # Layer 0's attention norm reads the frozen embedding: no gradient.
    assert _counts() == (2 * (2 * layers) + 1, 2 * layers, 0)
    rn.reset_launches()
    monkeypatch.setattr(rn, "rms_norm", rn.rms_norm_plain)
    loss_p, grads_p = llama._value_and_grad(loss_fn, adapters, params, ids)
    monkeypatch.undo()
    assert _counts() == (0, 0, 0)
    torch.testing.assert_close(loss, loss_p, rtol=1e-3, atol=0)
    for g, g_p in zip(torch.utils._pytree.tree_leaves(grads), torch.utils._pytree.tree_leaves(grads_p)):
        top = max(g_p.float().abs().max().item(), 1e-30)
        assert (g.float() - g_p.float()).abs().max().item() <= 0.02 * top
