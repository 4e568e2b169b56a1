"""The port's LM kernels (K3 row gather, K4 grouped matmul, K5 flash
attention, K6 SSD chunked scan) held against the reference's Pallas
kernels.

Inputs come from numpy seeds and go through both packages; JAX runs on
the CPU with Pallas in interpret mode, as ``tests/test_kernels.py`` runs
it. On the CPU the port's wrappers take their plain versions
(``repro_torch.kernels.ref``), so these tests hold the plain versions, the
wrappers' checks and the ops layer against the reference:

* K3 must match exactly (the reference's own test uses
  ``assert_array_equal``): it moves bytes and computes nothing.
* K4 is held at the reference's own tolerance (``tests/test_kernels.py``):
  rtol 2e-5 for float32 and 2e-2 for bfloat16, atol 8 x rtol, because
  the K sums run in another order than the reference's 128-wide steps
  (and, in bfloat16, the float32 sum is rounded to 8 bits of mantissa).
* K5 at the reference's own tolerances: 2e-5 for float32 (a softmax over
  float32 sums in another order) and 3e-2 for bfloat16 (outputs rounded
  to 8 bits of mantissa).
* K6 at the reference's own rtol 2e-4 / atol 2e-5, against the
  reference's kernel and against the sequential recurrence
  (``ref.ssd_seq_ref``): chunked sums and exps of cumulative sums in
  another order than one step at a time.

``gpu``-marked tests hold the CUDA kernels against the plain versions on
a card and skip without one:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py``.
"""

import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib, ops, ref
from repro_torch.kernels import coalesced_gather, flash_attention, moe_gmm
from repro_torch.kernels import ssd_scan
from repro_torch.models import moe as tmoe

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import coalesced_gather as rgather
    from repro.kernels import ops as rops
    from repro.models import moe as rmoe
except ImportError:     # a machine with a card and no jax: gpu tests only
    jnp = None

_TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _reference(request):
    """Every test but the ``gpu`` ones needs the reference (jax)."""
    if jnp is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("needs jax, the reference package's framework")


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jnp(a, dtype):
    x = jnp.asarray(a)
    return x if dtype is np.float32 else x.astype(jnp.bfloat16)


def _torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is np.float32 else t.to(torch.bfloat16)


def _np(x):
    """A jax array or torch tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ K3: gather


def _gather_inputs(t, tp, seed):
    rng = np.random.default_rng(seed)
    n = t // 2
    src = rng.integers(0, t, size=n)
    dest = rng.permutation(tp)[:n]
    return src, dest


@pytest.mark.parametrize("t,d,tp", [(64, 32, 128), (200, 48, 256),
                                    (4096, 640, 4096)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gather_plain_equals_reference(t, d, tp, dtype):
    """(4096, 640) float32 is 10.5 MB, above the reference's 8 MiB VMEM
    budget, so there the reference takes its XLA branch; the port has one
    path at every size."""
    x = _rand(3, (t, d))
    src, dest = _gather_inputs(t, tp, 4)
    over = t * d * (4 if dtype is np.float32 else 2) > \
        rgather.VMEM_BYTES_BUDGET
    assert over == (t == 4096 and dtype is np.float32)
    want = rops.coalesced_gather(_jnp(x, dtype), jnp.asarray(src),
                                 jnp.asarray(dest), tp, block=64)
    got = ops.coalesced_gather(_torch(x, dtype), torch.from_numpy(src),
                               torch.from_numpy(dest), tp, block=64)
    assert got.dtype == (torch.float32 if dtype is np.float32
                         else torch.bfloat16)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_gather_rows_plain_equals_reference_kernel():
    """The plain K3 against the Pallas kernel itself, with unfilled rows
    and a row_src entry out of range (clamped by both)."""
    x = _rand(5, (40, 24))
    rng = np.random.default_rng(6)
    row_src = rng.integers(0, 40, size=128).astype(np.int32)
    row_src[7] = 55
    row_valid = (rng.random(128) < 0.6).astype(np.int32)
    row_valid[7] = 1
    want = rgather.gather_rows(jnp.asarray(x), jnp.asarray(row_src),
                               jnp.asarray(row_valid), 128, bm=64)
    got = coalesced_gather.gather_rows(torch.from_numpy(x),
                                       torch.from_numpy(row_src),
                                       torch.from_numpy(row_valid), 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got[7].numpy(), x[39])


def test_gather_unfilled_rows_zero():
    x = torch.ones((8, 16))
    out = ops.coalesced_gather(x, torch.tensor([0]), torch.tensor([3]), 64)
    assert float(out[3].sum()) == 16.0
    assert float(out.sum()) == 16.0


def test_gather_rows_checks_shapes():
    x = torch.ones((8, 16))
    m = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="row_src"):
        coalesced_gather.gather_rows(x, m[:10], m, 64)
    with pytest.raises(ValueError, match=r"\(T, D\)"):
        coalesced_gather.gather_rows(x[None], m, m, 64)
    with pytest.raises(ValueError, match="use cuda or cpu"):
        coalesced_gather.gather_rows(x.to("meta"), m.to("meta"),
                                     m.to("meta"), 64)


@pytest.mark.parametrize("row_bytes,ptrs,want", [
    (4096, (0, 4096), 16), (192, (0, 64), 16), (96, (0, 32), 16),
    (40, (0, 8), 8), (12, (0, 4), 4), (6, (0, 2), 2), (3, (0, 1), 1),
    (64, (8, 0), 8)])
def test_gather_copy_word(row_bytes, ptrs, want):
    assert coalesced_gather._word_bytes(row_bytes, *ptrs) == want


# --------------------------------------------------------------- K4: gmm


@pytest.mark.parametrize("m,k,n,e,bm", [
    (128, 64, 64, 2, 64),
    (256, 96, 80, 4, 64),       # non-multiple N/K: masked edges
    (512, 128, 256, 8, 128),
])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gmm_plain_matches_reference(m, k, n, e, bm, dtype):
    x = _rand(0, (m, k))
    w = _rand(1, (e, k, n)) * 0.1
    be = np.random.default_rng(2).integers(0, e, size=m // bm).astype(
        np.int32)
    want = rops.moe_gmm(_jnp(x, dtype), _jnp(w, dtype), jnp.asarray(be),
                        block=bm)
    got = ops.moe_gmm(_torch(x, dtype), _torch(w, dtype),
                      torch.from_numpy(be), block=bm)
    tol = _TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 8)


def test_gmm_pad_expert_blocks_match_reference():
    """A block map like the serve path's (60 real experts of 64): here 6
    real of 8, from ``sort_by_expert``, whose trailing row blocks clamp to
    expert 7, a pad expert that routing never picks."""
    n_experts, block, t, k = 8, 64, 12, 2
    idx = np.random.default_rng(7).integers(0, 6, size=(t, k))
    _, _, be, t_pad = rmoe.sort_by_expert(jnp.asarray(idx), n_experts, block)
    be = np.array(be)
    assert be[-1] == n_experts - 1 and (be == n_experts - 1).sum() > 1
    x = _rand(8, (t_pad, 48))
    w = _rand(9, (n_experts, 48, 40)) * 0.1
    want = rops.moe_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(be),
                        block=block)
    got = ops.moe_gmm(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(be), block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1.6e-4)
    # The port's own sort gives the same map.
    _, _, tbe, t_pad2 = tmoe.sort_by_expert(torch.from_numpy(idx),
                                            n_experts, block)
    assert t_pad2 == t_pad and np.array_equal(tbe.numpy(), be)


def test_gmm_block_expert_selects_weights():
    """Each row-block must use exactly its expert's weights; an expert id
    past the last is clamped to it."""
    m, k, n, e, bm = 192, 32, 32, 4, 64
    x = torch.ones((m, k))
    w = torch.stack([torch.full((k, n), i + 1.0) for i in range(e)])
    be = torch.tensor([2, 0, 9], dtype=torch.int32)
    out = ops.moe_gmm(x, w, be, block=bm)
    assert float(out[0, 0]) == pytest.approx(3.0 * k)
    assert float(out[bm, 0]) == pytest.approx(1.0 * k)
    assert float(out[2 * bm, 0]) == pytest.approx(4.0 * k)


def test_gmm_checks_shapes():
    x = torch.ones((128, 32))
    w = torch.ones((2, 32, 16))
    be = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of bm"):
        moe_gmm.gmm(x[:100], w, be, bm=64)
    with pytest.raises(ValueError, match="block_expert"):
        moe_gmm.gmm(x, w, be[:1], bm=64)
    with pytest.raises(ValueError, match=r"\(E, 16, N\)"):
        moe_gmm.gmm(x, w[:, :16], be, bm=64)


@pytest.mark.parametrize("n_rows", [0, 96, 256, 512])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gmm_n_rows_matches_reference_with_rows_zeroed(n_rows, dtype):
    """``n_rows`` keeps the reference's product below it and zeroes the
    rows at and past it: none, mid-block (96 of bm 128), two blocks, all."""
    m, k, n, e, bm = 512, 96, 80, 4, 128
    x = _rand(0, (m, k))
    w = _rand(1, (e, k, n)) * 0.1
    be = np.random.default_rng(2).integers(0, e, size=m // bm).astype(
        np.int32)
    want = _np(rops.moe_gmm(_jnp(x, dtype), _jnp(w, dtype), jnp.asarray(be),
                            block=bm)).copy()
    want[n_rows:] = 0.0
    got = ops.moe_gmm(_torch(x, dtype), _torch(w, dtype),
                      torch.from_numpy(be), block=bm,
                      n_rows=torch.tensor(n_rows, dtype=torch.int32))
    assert got.dtype == _torch(x, dtype).dtype
    assert bool((got[n_rows:] == 0).all())
    tol = _TOL[dtype]
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * 8)


def test_gmm_n_rows_none_keeps_every_row():
    x = torch.ones((128, 8))
    w = torch.ones((1, 8, 8))
    be = torch.zeros(2, dtype=torch.int32)
    full = moe_gmm.gmm(x, w, be, bm=64)
    assert torch.equal(full, torch.full((128, 8), 8.0))
    past_m = torch.tensor([200], dtype=torch.int32)
    assert torch.equal(moe_gmm.gmm(x, w, be, bm=64, n_rows=past_m), full)
    with pytest.raises(ValueError, match="one count"):
        moe_gmm.gmm(x, w, be, bm=64, n_rows=torch.zeros(2, dtype=torch.int32))


def test_gmm_route_by_dtype_shape_and_alignment():
    """bf16 with K, N multiples of 8 on 16-byte boundaries takes the
    tensor cores; float32, a ragged K or N, or an offset x the CUDA
    cores."""
    bf16 = torch.bfloat16
    x = torch.zeros((128, 64), dtype=bf16)
    w = torch.zeros((2, 64, 80), dtype=bf16)
    assert moe_gmm.route(x, w) == "tensor_cores"
    assert moe_gmm.route(x.float(), w.float()) == "cuda_cores"
    assert moe_gmm.route(torch.zeros((128, 60), dtype=bf16),
                         torch.zeros((2, 60, 80), dtype=bf16)) == "cuda_cores"
    assert moe_gmm.route(x, torch.zeros((2, 64, 76), dtype=bf16)) == \
        "cuda_cores"
    offset = torch.zeros(128 * 64 + 4, dtype=bf16)[4:].view(128, 64)
    assert offset.is_contiguous() and offset.data_ptr() % 16 == 8
    assert moe_gmm.route(offset, w) == "cuda_cores"


# ------------------------------------------------------ K5: flash attention


def _qkv(seed, shape):
    return [_rand(seed + i, shape) for i in range(3)]


@pytest.mark.parametrize("bh,s,hd,bq,bkv", [
    (2, 128, 64, 64, 64),
    (4, 256, 32, 128, 64),
    (1, 512, 128, 128, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_reference(bh, s, hd, bq, bkv, causal):
    q, k, v = _qkv(6, (bh, s, hd))
    want = rops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                bq=bq, bkv=bkv)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, bq=bq, bkv=bkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_tile_granularity_invariance():
    """The tiles of the reference's kernel against the port's one result
    (its tiling is fixed): each within the reference's tolerance."""
    q, k, v = _qkv(9, (2, 256, 64))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    for bq, bkv in [(64, 64), (128, 64), (64, 128), (256, 256)]:
        want = rops.flash_attention(*map(jnp.asarray, (q, k, v)), bq=bq,
                                    bkv=bkv)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_flash_bf16_matches_reference():
    q, k, v = _qkv(12, (2, 128, 64))
    want = rops.flash_attention(*(_jnp(a, "bfloat16") for a in (q, k, v)))
    got = ops.flash_attention(*(_torch(a, "bfloat16") for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-2, atol=3e-2)


def test_flash_checks_shapes():
    q = torch.ones((2, 128, 64))
    with pytest.raises(ValueError, match="must divide"):
        flash_attention.flash_attention(q[:, :100], q[:, :100], q[:, :100],
                                        bq=64)
    with pytest.raises(ValueError, match=r"\(2, Sk, 64\)"):
        flash_attention.flash_attention(q, q[:, :, :32], q)
    with pytest.raises(ValueError, match=r"\(BH, S, hd\)"):
        flash_attention.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="use cuda or cpu"):
        flash_attention.flash_attention(q.to("meta"), q.to("meta"),
                                        q.to("meta"))


def test_flash_route_by_dtype():
    assert flash_attention.route(torch.zeros(1, dtype=torch.bfloat16)) == \
        "tensor_cores"
    assert flash_attention.route(torch.zeros(1)) == "cuda_cores"
    with pytest.raises(ValueError, match="float16"):
        flash_attention.route(torch.zeros(1, dtype=torch.float16))


# ------------------------------------------------------- K6: SSD scan


def _ssd_inputs(bh, s, p, n, seed=20):
    x = _rand(seed, (bh, s, p)) * 0.5
    da = -np.logaddexp(_rand(seed + 1, (bh, s)), 0.0).astype(np.float32)
    b = _rand(seed + 2, (bh, s, n)) * 0.3
    c = _rand(seed + 3, (bh, s, n)) * 0.3
    return x, da, b, c


@pytest.mark.parametrize("bh,s,p,n,q", [
    (2, 64, 16, 8, 16),
    (3, 128, 32, 16, 32),
    (1, 256, 64, 32, 64),
    (2, 64, 50, 16, 16),        # hymba's odd head width
])
def test_ssd_plain_matches_reference_and_sequential(bh, s, p, n, q):
    args = _ssd_inputs(bh, s, p, n)
    want = rops.ssd_scan(*map(jnp.asarray, args), chunk=q)
    got = ops.ssd_scan(*map(torch.from_numpy, args), chunk=q)
    seq = ref.ssd_seq_ref(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_ssd_seq_ref_matches_reference_oracle():
    """ssd_seq_ref is the reference test's _ssd_seq_ref, a lax.scan."""
    x, da, b, c = _ssd_inputs(2, 32, 8, 4, seed=30)

    def step(h, t):
        xt, dat, bt, ct = t
        h = h * jnp.exp(dat)[:, None, None] + xt[:, :, None] * bt[:, None, :]
        return h, jnp.einsum("bn,bpn->bp", ct, h)

    _, ys = jax.lax.scan(step, jnp.zeros((2, 8, 4)),
                         (jnp.asarray(x).transpose(1, 0, 2),
                          jnp.asarray(da).T,
                          jnp.asarray(b).transpose(1, 0, 2),
                          jnp.asarray(c).transpose(1, 0, 2)))
    got = ref.ssd_seq_ref(*map(torch.from_numpy, (x, da, b, c)))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ys.transpose(1, 0, 2)),
                               rtol=1e-5, atol=1e-6)


def test_ssd_chunk_invariance():
    args = _ssd_inputs(2, 128, 16, 8, seed=24)
    outs = [ops.ssd_scan(*map(torch.from_numpy, args), chunk=q).numpy()
            for q in (16, 32, 64, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0], o, rtol=2e-4, atol=2e-5)


def test_ssd_checks_shapes():
    x = torch.ones((2, 64, 16))
    da = -torch.ones((2, 64))
    b = torch.ones((2, 64, 8))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan.ssd_scan_kernel(x, da, b, b, chunk=48)
    with pytest.raises(ValueError, match=r"da must be \(2, 64\)"):
        ssd_scan.ssd_scan_kernel(x, da[:, :32], b, b)
    with pytest.raises(ValueError, match=r"\(BH, S\)"):
        ssd_scan.ssd_scan_kernel(x, da[None], b, b)
    with pytest.raises(ValueError, match="use cuda or cpu"):
        ssd_scan.ssd_scan_kernel(x.to("meta"), da.to("meta"), b.to("meta"),
                                 b.to("meta"), chunk=16)


# ----------------------------------------------- build, launch, no fallback


def test_launch_counts_reset_and_cover_both_kernels():
    _lib.reset_launch_counts()
    assert _lib.KERNELS == ("gather_rows_kernel", "gmm_kernel",
                            "flash_attention_kernel", "ssd_scan_kernel")
    assert {k: _lib.launch_count(k) for k in _lib.KERNELS} == {
        k: 0 for k in _lib.KERNELS}
    # The plain versions on the CPU are not launches.
    ops.moe_gmm(torch.ones((64, 8)), torch.ones((1, 8, 8)),
                torch.zeros(1, dtype=torch.int32), block=64)
    ops.coalesced_gather(torch.ones((2, 8)), torch.tensor([1]),
                         torch.tensor([0]), 64)
    ops.flash_attention(torch.ones((1, 8, 8)), torch.ones((1, 8, 8)),
                        torch.ones((1, 8, 8)))
    ops.ssd_scan(torch.ones((1, 8, 4)), -torch.ones((1, 8)),
                 torch.ones((1, 8, 2)), torch.ones((1, 8, 2)), chunk=8)
    assert {k: _lib.launch_count(k) for k in _lib.KERNELS} == {
        k: 0 for k in _lib.KERNELS}


def test_route_counts_reset_with_launch_counts():
    _lib.reset_launch_counts()
    _lib.count_launch("gmm_kernel", "tensor_cores")
    _lib.count_launch("gmm_kernel", "tensor_cores")
    _lib.count_launch("flash_attention_kernel", "cuda_cores")
    _lib.count_launch("gather_rows_kernel")
    assert _lib.launch_count("gmm_kernel") == 2
    assert _lib.route_count("gmm_kernel", "tensor_cores") == 2
    assert _lib.route_count("gmm_kernel", "cuda_cores") == 0
    assert _lib.route_count("flash_attention_kernel", "cuda_cores") == 1
    assert _lib.launch_count("gather_rows_kernel") == 1
    _lib.reset_launch_counts()
    assert _lib.launch_count("gmm_kernel") == 0
    assert _lib.route_count("gmm_kernel", "tensor_cores") == 0


@pytest.mark.parametrize("kernel", ["gather_rows_kernel", "gmm_kernel",
                                    "flash_attention_kernel",
                                    "ssd_scan_kernel"])
def test_failed_build_raises(tmp_path, monkeypatch, kernel):
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_lib, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _lib.build(kernel)
    assert list(tmp_path.iterdir()) == []


def test_failed_launch_raises():
    class FakeLib:
        @staticmethod
        def kernel_error_string(code):
            return b"invalid configuration argument"

    _lib.check_launch(FakeLib, "gmm_kernel", 0)
    with pytest.raises(RuntimeError, match="gmm_kernel launch failed"):
        _lib.check_launch(FakeLib, "gmm_kernel", 9)


def test_sources_name_the_kernels_they_replace():
    for kernel, src in _lib.SOURCES.items():
        text = (_lib.CSRC / src).read_text(encoding="utf-8")
        assert "__global__ void" in text and kernel in text, src
        assert "Replaces src/repro/kernels/" in text, src
        assert "Bound on this card" in text, src
        assert "extern \"C\" const char *kernel_error_string" in text, src


# --------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("t,d,tp", [(64, 32, 128), (200, 48, 256),
                                    (31, 2048, 8320), (5, 3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_kernel_equals_plain_on_card(card, t, d, tp, dtype):
    x = torch.from_numpy(_rand(3, (t, d))).to(card, dtype)
    rng = np.random.default_rng(4)
    row_src = torch.from_numpy(rng.integers(0, t, size=tp).astype(
        np.int32)).to(card)
    row_valid = torch.from_numpy((rng.random(tp) < 0.5).astype(
        np.int32)).to(card)
    before = _lib.launch_count("gather_rows_kernel")
    got = coalesced_gather.gather_rows(x, row_src, row_valid, tp)
    torch.cuda.synchronize()
    assert _lib.launch_count("gather_rows_kernel") == before + 1
    want = ref.gather_rows_ref(x, row_src, row_valid, tp)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,e,bm", [
    (128, 64, 64, 2, 64), (256, 96, 80, 4, 64), (512, 128, 256, 8, 128),
    (1024, 2048, 1408, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_within_tolerance_on_card(card, m, k, n, e, bm, dtype):
    x = torch.from_numpy(_rand(0, (m, k))).to(card, dtype)
    w = (torch.from_numpy(_rand(1, (e, k, n))) * 0.1).to(card, dtype)
    be = torch.from_numpy(np.random.default_rng(2).integers(
        0, e, size=m // bm).astype(np.int32)).to(card)
    before = _lib.launch_count("gmm_kernel")
    got = moe_gmm.gmm(x, w, be, bm=bm)
    torch.cuda.synchronize()
    assert _lib.launch_count("gmm_kernel") == before + 1
    want = ref.gmm_ref(x, w, be, bm)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * 8)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,hd", [(2, 128, 64), (4, 256, 32),
                                     (1, 512, 128), (3, 100, 40)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_within_tolerance_on_card(card, bh, s, hd, causal,
                                               dtype):
    """The reference's shapes, and ragged S and hd (3, 100, 40)."""
    q, k, v = (torch.from_numpy(a).to(card, dtype)
               for a in _qkv(6, (bh, s, hd)))
    before = _lib.launch_count("flash_attention_kernel")
    got = flash_attention.flash_attention(q, k, v, causal=causal, bq=s,
                                          bkv=s)
    torch.cuda.synchronize()
    assert _lib.launch_count("flash_attention_kernel") == before + 1
    want = ref.flash_attention_ref(q, k, v, causal)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,s,p,n,q", [
    (2, 64, 16, 8, 16), (3, 128, 32, 16, 32), (1, 256, 64, 32, 64),
    (2, 64, 50, 16, 16), (2, 512, 64, 128, 256),
    # K6's tile edges: q and P not multiples of its 64-wide tiles, P and N
    # past 64, N and P not multiples of 4.
    (2, 320, 50, 16, 160), (2, 96, 100, 72, 48), (1, 200, 66, 36, 100),
    (1, 130, 64, 30, 65)])
def test_ssd_kernel_within_tolerance_on_card(card, bh, s, p, n, q):
    args = [torch.from_numpy(a).to(card) for a in _ssd_inputs(bh, s, p, n)]
    before = _lib.launch_count("ssd_scan_kernel")
    got = ssd_scan.ssd_scan_kernel(*args, chunk=q)
    torch.cuda.synchronize()
    assert _lib.launch_count("ssd_scan_kernel") == before + 1
    for want in (ref.ssd_scan_ref(*args, q), ref.ssd_seq_ref(*args)):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


TC_GMM_SHAPES = [(256, 96, 80), (512, 136, 264), (1024, 2048, 1408)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", TC_GMM_SHAPES)
@pytest.mark.parametrize("bm", [64, 128])
def test_gmm_tensor_core_route_on_card(card, m, k, n, bm):
    """bf16 through the tensor-core route at ragged K/N and the serve's
    (2048, 1408): n_rows 0, mid-block and full equal gmm_ref(..., n_rows)
    within the reference's bf16 tolerance, with the rows past n_rows
    exactly zero; None keeps every row."""
    e = 8
    x = torch.from_numpy(_rand(0, (m, k))).to(card, torch.bfloat16)
    w = (torch.from_numpy(_rand(1, (e, k, n))) * 0.1).to(card, torch.bfloat16)
    be = torch.from_numpy(np.random.default_rng(2).integers(
        0, e, size=m // bm).astype(np.int32)).to(card)
    assert moe_gmm.route(x, w) == "tensor_cores"
    for n_rows in (0, bm + bm // 2, m, None):
        nr = (None if n_rows is None
              else torch.tensor(n_rows, dtype=torch.int32, device=card))
        before = _lib.route_count("gmm_kernel", "tensor_cores")
        got = moe_gmm.gmm(x, w, be, bm=bm, n_rows=nr)
        torch.cuda.synchronize()
        assert _lib.route_count("gmm_kernel", "tensor_cores") == before + 1
        want = ref.gmm_ref(x, w, be, bm, nr)
        if n_rows is not None:
            assert bool((got[n_rows:] == 0).all())
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=0.16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_n_rows_equals_none_on_zero_padded_x_on_card(card, dtype):
    """Where x is zero past n_rows (as K3 leaves it on the serve path),
    skipping those blocks changes no bit of the output, on either route."""
    m, k, n, e, bm, n_rows = 1024, 256, 384, 8, 128, 384
    x = torch.from_numpy(_rand(3, (m, k))).to(card, dtype)
    x[n_rows:] = 0
    w = (torch.from_numpy(_rand(4, (e, k, n))) * 0.1).to(card, dtype)
    be = torch.from_numpy(np.random.default_rng(5).integers(
        0, e, size=m // bm).astype(np.int32)).to(card)
    nr = torch.tensor([n_rows], dtype=torch.int32, device=card)
    skipped = moe_gmm.gmm(x, w, be, bm=bm, n_rows=nr)
    full = moe_gmm.gmm(x, w, be, bm=bm)
    torch.cuda.synchronize()
    assert torch.equal(skipped, full)
    assert bool((full[n_rows:] == 0).all())


@pytest.mark.gpu
def test_bf16_calls_launch_the_tensor_core_routes(card):
    _lib.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.ones((128, 64), dtype=dtype, device=card)
        w = torch.ones((2, 64, 64), dtype=dtype, device=card)
        moe_gmm.gmm(x, w, torch.zeros(2, dtype=torch.int32, device=card),
                    bm=64)
        q = torch.ones((1, 64, 64), dtype=dtype, device=card)
        flash_attention.flash_attention(q, q, q)
    torch.cuda.synchronize()
    for kernel in ("gmm_kernel", "flash_attention_kernel"):
        assert _lib.route_count(kernel, "tensor_cores") == 1, kernel
        assert _lib.route_count(kernel, "cuda_cores") == 1, kernel
        assert _lib.launch_count(kernel) == 2, kernel


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [40, 64, 128])
@pytest.mark.parametrize("s", [100, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_routes_within_tolerance_on_card(card, hd, s, causal, dtype):
    """Both routes at the reference's tolerances (2e-5 float32, 3e-2
    bf16), at hd 40 (padded to 64 on the tensor cores), 64 and 128, at a
    ragged S and at S 2048."""
    q, k, v = (torch.from_numpy(a).to(card, dtype)
               for a in _qkv(11, (2, s, hd)))
    way = flash_attention.route(q)
    assert way == ("tensor_cores" if dtype == torch.bfloat16
                   else "cuda_cores")
    before = _lib.route_count("flash_attention_kernel", way)
    got = flash_attention.flash_attention(q, k, v, causal=causal, bq=s,
                                          bkv=s)
    torch.cuda.synchronize()
    assert _lib.route_count("flash_attention_kernel", way) == before + 1
    want = ref.flash_attention_ref(q, k, v, causal)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tile_invariance_on_card(card, dtype):
    """The reference's four tile sizes give one result on the card, within
    the reference's tolerance of the plain version."""
    q, k, v = (torch.from_numpy(a).to(card, dtype)
               for a in _qkv(9, (2, 256, 64)))
    want = ref.flash_attention_ref(q, k, v, True)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    outs = [flash_attention.flash_attention(q, k, v, True, bq, bkv)
            for bq, bkv in [(64, 64), (128, 64), (64, 128), (256, 256)]]
    torch.cuda.synchronize()
    for out in outs:
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(out, outs[0])
