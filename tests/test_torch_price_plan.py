"""The host side of K1 and K3 on the CPU: the launch geometry of each kernel
(`k1_plan`, `k3_plan`), its scratch and counters, the input checks and
the dtypes the wrappers hand the kernels, and the plain versions against
the JAX package's Pallas kernels (interpret mode) on the ragged shapes the
kernels must handle.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clp_tpu.ops.pallas_price import (
    price_and_ratios as jax_price,
    price_and_ratios_block as jax_price_block,
)
from clp_tpu_torch.ops import price
from clp_tpu_torch.ops.price import (
    K1_COLS,
    K1_MIN_ROWS,
    K3_COLS,
    MAX_GRID,
    k1_plan,
    k3_plan,
    price_and_ratios,
    price_and_ratios_block,
)

from test_torch_cuda import assert_price_close, block_price_inputs
from tests.worker_threads import set_worker_threads

set_worker_threads()


def assert_splits_tile(plan, depth, min_rows):
    """The row splits [s*rows, min(depth, (s+1)*rows)) cover 0..depth-1
    once each, with no empty split."""
    rows = plan.rows_per_split
    spans = [(s * rows, min(depth, (s + 1) * rows)) for s in range(plan.splits)]
    assert spans[0][0] == 0 and spans[-1][1] == depth
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(len(spans) - 1))
    # a split is never thinner than min_rows unless the whole depth is
    assert plan.splits == 1 or rows >= min_rows


def assert_grid_fits(plan, sms, ncols):
    assert plan.grid == plan.tiles * plan.splits <= MAX_GRID
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    # a scratch row and a counter per tile only where blocks share a tile
    many = plan.splits > 1
    assert plan.scratch_shape == (plan.splits if many else 0, ncols)
    assert plan.counters == (plan.tiles if many else 0)
    # split-major numbering gives every (tile, split) pair one block
    pairs = {(b % plan.tiles, b // plan.tiles) for b in range(plan.grid)}
    assert len(pairs) == plan.grid
    assert pairs == {(t, s) for t in range(plan.tiles) for s in range(plan.splits)}
    # with more than one split every block is resident at once
    assert plan.splits == 1 or plan.grid <= price.K1_BLOCKS_PER_SM * sms


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("nt", [1, 3, 127, 6656, 6657])
@pytest.mark.parametrize("m", [1, 7, 2048, 14464])
def test_k1_plan_covers_g(m, nt, sms):
    plan = k1_plan(m, nt, sms)
    assert plan.tile_cols == K1_COLS
    cols = [j for t in range(plan.tiles)
            for j in range(t * K1_COLS, min(nt, (t + 1) * K1_COLS))]
    assert cols == list(range(nt)), "every column in exactly one tile"
    assert (plan.tiles - 1) * K1_COLS < nt  # no tile without a column
    assert_splits_tile(plan, m, K1_MIN_ROWS)
    assert_grid_fits(plan, sms, nt)


@pytest.mark.parametrize("nb, H, CB", [(1, 8, 1), (7, 37, 100), (52, 264, 128),
                                       (3, 2100, 200), (2, 0, 5)])
def test_k3_plan_covers_tiles(nb, H, CB):
    plan = k3_plan(nb, H, CB)
    assert plan.tile_cols == K3_COLS
    col_tiles = plan.tiles // nb
    assert plan.tiles == nb * col_tiles and (col_tiles - 1) * K3_COLS < CB
    # block t takes column group t % col_tiles of tile t // col_tiles; its
    # output columns are b*CB + c for c < CB
    out = [(t // col_tiles) * CB + c for t in range(plan.tiles)
           for c in range((t % col_tiles) * K3_COLS,
                          min(CB, (t % col_tiles + 1) * K3_COLS))]
    assert out == list(range(nb * CB)), "every output column exactly once"
    # one block reads all H rows of its window: no split, no scratch
    assert plan.splits == 1 and plan.rows_per_split >= H
    assert_grid_fits(plan, 1, nb * CB)


def test_main_path_geometry():
    """The staircase's shapes on the H100's 132 SMs, as the kernels' notes
    give them: K1 52 tiles x 10 splits of 205 rows, 4 blocks on each SM;
    K3 52 tiles x 4 blocks of 32 columns, at most 2 on any SM."""
    p1 = k1_plan(2048, 6656, 132)
    assert (p1.tiles, p1.splits, p1.rows_per_split, p1.grid) == (52, 10, 205, 520)
    assert -(-p1.grid // 132) == price.K1_BLOCKS_PER_SM
    p3 = k3_plan(52, 264, 128)
    assert (p3.tiles, p3.splits, p3.grid) == (208, 1, 208)
    assert -(-p3.grid // 132) == 2


@pytest.mark.parametrize("plan, args", [
    (k1_plan, (-1, 5, 132)), (k1_plan, (4, 0, 132)), (k1_plan, (4, 5, 0)),
    (k3_plan, (0, 8, 1)), (k3_plan, (1, 8, 0)), (k3_plan, (1, -1, 4)),
], ids=lambda x: getattr(x, "__name__", str(x)))
def test_plans_refuse_bad_shapes(plan, args):
    with pytest.raises(ValueError):
        plan(*args)


# ---------------------------------------------------------------------------
# scratch, counters and the vectors as the kernels read them
# ---------------------------------------------------------------------------


def test_workspace_is_made_once_per_device(monkeypatch):
    monkeypatch.setattr(price, "_workspaces", {})
    dev = torch.device("cpu")
    small, big = k1_plan(700, 300, 132), k1_plan(2048, 6656, 132)
    assert small.splits > 1
    w1 = price._workspace(dev, small)
    assert w1[0].dtype == torch.float32 and w1[1].dtype == torch.int32
    assert w1[0].numel() >= small.splits * 300 and w1[1].numel() >= small.tiles
    assert not w1[1].any(), "counters start at zero"
    w2 = price._workspace(dev, small)
    assert w2[0] is w1[0] and w2[1] is w1[1], "a second call reuses the buffers"
    # a larger need grows the buffers, zeroed counters and all; a smaller
    # one after it reuses them
    w3 = price._workspace(dev, big)
    assert w3[0].numel() >= 10 * 6656 and w3[1].numel() >= 52 and not w3[1].any()
    assert price._workspace(dev, small)[0] is w3[0]
    # one split needs no scratch, and takes the cached one as it is
    assert price._workspace(dev, k1_plan(7, 300, 132))[0] is w3[0]


@pytest.mark.parametrize("dj, elig, sgn, sigma, flags", [
    (torch.float32, torch.int32, torch.float32, 1.0, 0),
    (torch.float64, torch.bool, torch.float64, torch.float64, 15),
    (torch.float64, torch.uint8, torch.float32, torch.float32, 1 | 8),
    (torch.float16, torch.int64, torch.float64, torch.int64, 2),
])
def test_kernel_vectors_pass_as_stored(dj, elig, sgn, sigma, flags):
    """f32/f64 vectors, a bool or byte mask and an f32/f64 sigma reach the
    kernel as the engine holds them (no cast launched); anything else is
    cast once to what the kernel reads."""
    n = 5
    dev = torch.device("cpu")
    sig = sigma if isinstance(sigma, float) else torch.tensor(-1, dtype=sigma)
    args = (torch.ones(n, dtype=dj), torch.ones(n, dtype=elig), torch.ones(n, dtype=sgn))
    d, e, s, g, f = price._kernel_vecs(*args, sig, dev)
    assert f == flags
    assert d.dtype in (torch.float32, torch.float64) and s.dtype in (torch.float32,
                                                                    torch.float64)
    assert e.dtype in (torch.bool, torch.uint8, torch.int8, torch.int32)
    assert g.shape == (1,) and g.dtype in (torch.float32, torch.float64)
    for given, got in zip(args, (d, e, s)):
        if given.dtype == got.dtype:
            assert got.data_ptr() == given.data_ptr()


def _k1_args(device, **dtypes):
    rng = np.random.default_rng(5)
    m, nt = 6, 10
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
    return [t(rng.standard_normal(m)), t(rng.standard_normal((m, nt))),
            t(np.abs(rng.standard_normal(nt)), dtypes.get("dj", torch.float32)),
            t(rng.random(nt) < 0.7, dtypes.get("elig", torch.bool)),
            t(np.sign(rng.standard_normal(nt)), dtypes.get("sgn", torch.float32))]


def _k3_args(device, n=None):
    x = block_price_inputs(37, nb=3, CB=100)
    n = 300 if n is None else n
    t = {k: torch.as_tensor(v, device=device) for k, v in x.items()}
    return [t["rho_p"], t["starts"], t["W"], t["dj"][:n], t["elig"][:n], t["sgn"][:n]]


def _no_cuda(monkeypatch):
    """Make any step past the device check fail loudly."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA step ran before the device check")

    monkeypatch.setattr(price, "_workspace", refuse)
    monkeypatch.setattr(price, "_sm_count", refuse)
    monkeypatch.setattr(price, "_launch", refuse)
    monkeypatch.setattr(price, "_launch_block", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)


@pytest.mark.parametrize("kernel", ["K1", "K3"])
@pytest.mark.parametrize("sigma", [1.0, "f64"])
def test_wrappers_refuse_meta_before_any_cuda_step(monkeypatch, kernel, sigma):
    _no_cuda(monkeypatch)
    sig = torch.tensor(1.0, dtype=torch.float64, device="meta") if sigma == "f64" else sigma
    if kernel == "K1":
        args, fn = _k1_args("meta", dj=torch.float64), price_and_ratios
    else:
        args, fn = _k3_args("meta", n=290), price_and_ratios_block
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*args, sig, 5e-8, 1e-9)


@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_wrappers_refuse_mixed_devices_and_bad_shapes(monkeypatch, kernel):
    _no_cuda(monkeypatch)
    if kernel == "K1":
        args, fn, vec = _k1_args("cpu"), price_and_ratios, 2
    else:
        args, fn, vec = _k3_args("cpu"), price_and_ratios_block, 3
    bad = list(args)
    bad[vec] = bad[vec].to("meta")
    with pytest.raises(ValueError, match="dj"):
        fn(*bad, 1.0, 5e-8, 1e-9)
    with pytest.raises(ValueError, match="sigma"):
        fn(*args, torch.ones(2), 5e-8, 1e-9)
    bad = list(args)
    bad[vec + 2] = bad[vec + 2][:-1]  # sgn one short
    with pytest.raises(ValueError, match="sgn"):
        fn(*bad, 1.0, 5e-8, 1e-9)


def test_block_wrapper_refuses_vectors_longer_than_the_tiles(monkeypatch):
    _no_cuda(monkeypatch)
    args = _k3_args("cpu")
    longer = [torch.cat([v, v[:1]]) for v in args[3:]]
    with pytest.raises(ValueError, match="n <= 300"):
        price_and_ratios_block(*args[:3], *longer, 1.0, 5e-8, 1e-9)


@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_cpu_path_runs_plain_and_launches_nothing(monkeypatch, kernel):
    _no_cuda(monkeypatch)
    if kernel == "K1":
        args = _k1_args("cpu", dj=torch.float64, sgn=torch.float64)
        fn, ref, count = price_and_ratios, price.price_and_ratios_reference, price_and_ratios
        f32 = [args[0], args[1], args[2].float(), args[3].int(), args[4].float()]
    else:
        args = _k3_args("cpu")
        fn, ref = price_and_ratios_block, price.price_and_ratios_block_reference
        count, f32 = price_and_ratios_block, args
    n = count.launches
    sig = torch.tensor(-1.0, dtype=torch.float64)
    a, r = fn(*args, sig, 5e-8, 1e-9)
    a0, r0 = ref(*f32, torch.tensor(-1.0), 5e-8, 1e-9)
    assert count.launches == n
    assert torch.equal(a, a0) and torch.equal(r, r0)


def test_block_wrapper_pads_short_vectors_as_the_engine_did():
    """The engine hands K3 dj, the mask and sgn unpadded; the result is the
    one of the padded call (dj = 0, elig = 0, sgn = 1 beyond n)."""
    args = _k3_args("cpu")
    n = 257
    a1, r1 = price_and_ratios_block(*args[:3], *(v[:n] for v in args[3:]), 1.0, 5e-8, 1e-9)
    pad = 300 - n
    padded = [torch.nn.functional.pad(args[3][:n], (0, pad)),
              torch.nn.functional.pad(args[4][:n], (0, pad)),
              torch.nn.functional.pad(args[5][:n], (0, pad), value=1.0)]
    a2, r2 = price_and_ratios_block(*args[:3], *padded, 1.0, 5e-8, 1e-9)
    assert torch.equal(a1, a2) and torch.equal(r1, r2)
    assert torch.isinf(r1[n:]).all()


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels on ragged shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [1.0, -1.0])
@pytest.mark.parametrize("m, nt", [(24, 1), (24, 3), (7, 127), (9, 6657)])
def test_k1_plain_matches_pallas_on_ragged_shapes(m, nt, sigma):
    """nt % 4 != 0 (the kernel's scalar loads) and nt < 128 (one partial
    tile); the wrapper on the CPU runs the plain version."""
    rng = np.random.default_rng(nt)
    x = dict(rho=rng.standard_normal(m).astype(np.float32),
             G=rng.standard_normal((m, nt)).astype(np.float32),
             dj=np.abs(rng.standard_normal(nt)).astype(np.float32),
             elig=rng.uniform(size=nt) < 0.7,
             sgn=np.where(rng.uniform(size=nt) < 0.5, 1.0, -1.0).astype(np.float32))
    rel, ptol = 5e-8, 1e-9
    a_j, r_j = jax_price(*(jnp.asarray(x[k]) for k in ("rho", "G", "dj", "elig", "sgn")),
                         jnp.asarray(sigma), jnp.asarray(rel), ptol, block_n=256,
                         interpret=True)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    a_t, r_t = price_and_ratios(t["rho"], t["G"], t["dj"], t["elig"], t["sgn"],
                                torch.tensor(sigma, dtype=torch.float64), rel, ptol)
    assert a_t.shape == (nt,)
    assert_price_close(a_t.numpy(), r_t.numpy(), np.asarray(a_j), np.asarray(r_j))


@pytest.mark.parametrize("nb, H, CB", [(1, 8, 1), (7, 37, 100), (3, 61, 200)])
def test_k3_plain_matches_pallas_on_ragged_shapes(nb, H, CB):
    """H no multiple of the row split, CB no multiple of 128 (or of 4), one
    column; dj, the mask and sgn passed unpadded to the port, padded to the
    JAX function."""
    x = block_price_inputs(H, nb=nb, CB=CB)
    ntp = nb * CB
    n = max(1, ntp - 5)
    rng = np.random.default_rng(H)
    x["rho_p"] = rng.standard_normal(x["rho_p"].shape[0]).astype(np.float32)
    x["W"] = rng.standard_normal(x["W"].shape).astype(np.float32)
    x["elig"][n:] = False
    x["dj"][n:] = 0.0
    x["sgn"][n:] = 1.0
    rel, ptol = 5e-8, 1e-9
    a_j, r_j = jax_price_block(jnp.asarray(x["rho_p"]), jnp.asarray(x["starts"]),
                               jnp.asarray(x["W"]), jnp.asarray(x["dj"]),
                               jnp.asarray(x["elig"].astype(np.int32)),
                               jnp.asarray(x["sgn"]), jnp.asarray(-1.0), rel, ptol,
                               interpret=True)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    a_t, r_t = price_and_ratios_block(t["rho_p"], t["starts"], t["W"], t["dj"][:n],
                                      t["elig"][:n], t["sgn"][:n], -1.0, rel, ptol)
    assert a_t.shape == r_t.shape == (ntp,)
    assert_price_close(a_t.numpy(), r_t.numpy(), np.asarray(a_j), np.asarray(r_j))
