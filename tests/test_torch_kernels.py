"""The port's LM kernels (K3 row gather, K4 grouped matmul) held against
the reference's Pallas kernels.

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

``gpu``-marked tests hold the CUDA kernels against the plain versions on
a card and skip without one:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py``.
"""

import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib, ops, ref
from repro_torch.kernels import coalesced_gather, moe_gmm
from repro_torch.models import moe as tmoe

try:
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


# ----------------------------------------------- build, launch, no fallback


def test_launch_counts_reset_and_cover_both_kernels():
    _lib.reset_launch_counts()
    assert _lib.KERNELS == ("gather_rows_kernel", "gmm_kernel")
    assert {k: _lib.launch_count(k) for k in _lib.KERNELS} == {
        "gather_rows_kernel": 0, "gmm_kernel": 0}
    # The plain versions on the CPU are not launches.
    ops.moe_gmm(torch.ones((64, 8)), torch.ones((1, 8, 8)),
                torch.zeros(1, dtype=torch.int32), block=64)
    ops.coalesced_gather(torch.ones((2, 8)), torch.tensor([1]),
                         torch.tensor([0]), 64)
    assert _lib.launch_count("gmm_kernel") == 0
    assert _lib.launch_count("gather_rows_kernel") == 0


@pytest.mark.parametrize("kernel", ["gather_rows_kernel", "gmm_kernel"])
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
