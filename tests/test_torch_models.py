"""The port's model stack and serving driver held against the reference.

The same weights, drawn with numpy (``repro_torch.models.convert``), go
through both packages; JAX runs on the CPU with Pallas in interpret mode.
Tolerances, each with its reason:

* Exact: configs, the registry, ``sort_by_expert`` (integer work), the
  router's expert choice, the served tokens, and weights carried through
  ``convert``.
* rtol 1e-4, atol 1e-5 for the MoE dispatches (the reference's own for
  sw_plus/lw_plus against its oracle, ``tests/test_models.py``): float32
  sums in another order (XLA's CPU dots against PyTorch's).
* rtol 1e-5, atol 1e-6 for norms and rope; 2e-5 for attention (a softmax
  over float32 sums in another order).
* Logits of prefill, decode and serving: :data:`LOGIT_TOL` (rtol 1e-4,
  atol 1e-4 on logits below 1 in size): float32 sums in another order
  stay far inside it, while a wrong expert, a wrong cache row or a
  flipped route moves logits far outside it.

Regenerate the golden file of the reference's smoke serve (which
``chip_smoke.py`` checks the card against) with
``PYTHONPATH=src:tests python tests/test_torch_models.py --write-golden``.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TModelConfig

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as rregistry
    from repro.launch import serve as rserve
    from repro.models import attention as rattn
    from repro.models import common as rcommon
    from repro.models import model as rmodel
    from repro.models import moe as rmoe
    from repro.models.config import ModelConfig as RModelConfig
except ImportError:     # a machine with a card and no jax: gpu tests only
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_FILE = os.path.join(REPO, "src", "repro_torch", "models", "data",
                           "serve_golden_qwen2moe_smoke.json")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MIN_TOP2_GAP = 1e-3
MOE_TOL = dict(rtol=1e-4, atol=1e-5)
# The smoke serve that the golden file holds and chip_smoke.py replays.
# Seed 6 for weights and prompts: no step's two largest logits lie within
# MIN_TOP2_GAP of each other (test_golden_logits_have_no_near_tie; seed 0
# has a near tie), so float32 sums in another order cannot flip a token.
GOLDEN_SERVE = dict(arch="qwen2-moe-a2.7b", smoke=True, dtype="float32",
                    moe_dispatch="sw_plus", seed=6, requests=5, slots=2,
                    max_new=6, max_len=64)


def _need_reference():
    if jax is None:
        pytest.skip("needs jax, the reference package's framework")


@pytest.fixture(autouse=True)
def _reference(request):
    """Every test but the ``gpu`` ones needs the reference (jax)."""
    if request.node.get_closest_marker("gpu") is None:
        _need_reference()


def _cfg(family="dense", **kw):
    base = dict(name=f"t-{family}", family=family, n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                vocab_size=128, dtype="float32")
    if family == "moe":
        base.update(d_ff=0, n_kv_heads=4,
                    moe_experts=8, moe_shared=1, moe_top_k=2, moe_d_ff=32)
    base.update(kw)
    return RModelConfig(**base).validate(), TModelConfig(**base).validate()


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _port_golden_cfg():
    g = GOLDEN_SERVE
    return dataclasses.replace(tregistry.get_config(g["arch"], g["smoke"]),
                               dtype=g["dtype"],
                               moe_dispatch=g["moe_dispatch"])


def _golden_cfgs():
    g = GOLDEN_SERVE
    rcfg = dataclasses.replace(rregistry.get_config(g["arch"], g["smoke"]),
                               dtype=g["dtype"],
                               moe_dispatch=g["moe_dispatch"])
    return rcfg, _port_golden_cfg()


# --------------------------------------------------- configs and registry


@pytest.mark.parametrize("arch", tregistry.list_archs())
def test_configs_match_reference(arch):
    assert tregistry.list_archs() == rregistry.list_archs()
    for smoke in (False, True):
        r = rregistry.get_config(arch, smoke)
        t = tregistry.get_config(arch, smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        for prop in ("vocab_padded", "n_q_eff", "n_kv_eff", "kv_repeat",
                     "moe_experts_eff", "d_inner", "ssm_heads", "attn_dim"):
            assert getattr(t, prop) == getattr(r, prop), (arch, prop)
    assert tregistry.runnable_shapes(arch) == rregistry.runnable_shapes(arch)
    assert tregistry.LONG_CONTEXT_ARCHS == rregistry.LONG_CONTEXT_ARCHS


def test_unknown_arch_and_family_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        tregistry.get_config("gpt-17")
    _, cfg = _cfg("ssm", n_heads=1, n_kv_heads=1, ssm_state=16,
                  ssm_headdim=16)
    assert "ssm" in tmodel.init_params(cfg, 0, "cpu")["layers"]
    cfg = dataclasses.replace(cfg, family="rwkv")
    with pytest.raises(NotImplementedError, match="rwkv"):
        tmodel.init_params(cfg, 0, "cpu")
    _, moe = _cfg("moe", moe_dispatch="sw_plus_ep")
    with pytest.raises(AssertionError, match="granularity.set_mesh"):
        tmoe.moe_layer({}, torch.zeros((1, 2, 64)), moe)


# ---------------------------------------------------------------- layers


def test_rms_norm_matches_reference():
    x, s = _rand(0, (3, 5, 64)), _rand(1, (64,))
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           rcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6),
           rtol=1e-5, atol=1e-6)
    _close(tcommon.head_rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
           rcommon.head_rms_norm(jnp.asarray(x), jnp.asarray(s)),
           rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_reference(theta):
    x = _rand(2, (2, 7, 4, 16))
    pos = np.arange(3, 10)
    _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta),
           rcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           rtol=1e-5, atol=1e-5)
    _close(tcommon.sinusoidal_pos_emb(torch.from_numpy(pos), 32),
           rcommon.sinusoidal_pos_emb(jnp.asarray(pos), 32),
           rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window,kv_chunk", [(None, 1024), (5, 8),
                                             (None, 6)])
def test_flash_attention_matches_reference(window, kv_chunk):
    q, k, v = _rand(3, (2, 19, 4, 16)), _rand(4, (2, 19, 2, 16)), \
        _rand(5, (2, 19, 2, 16))
    pos = np.arange(19)
    want = rattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(pos),
                                 jnp.asarray(pos), window, kv_chunk)
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(pos),
                                torch.from_numpy(pos), window, kv_chunk)
    _close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_matches_reference(window):
    rcfg, tcfg = _cfg(sliding_window=window, n_heads=5, tp_divisor=4)
    assert tcfg.n_q_eff == 8                 # pad heads are masked
    tree = convert.numpy_params(tcfg, 0)
    lp = jax.tree.map(lambda a: a[0], tree["layers"])["attn"]
    x = _rand(6, (2, 1, 64))
    kc, vc = _rand(7, (2, 9, 4, 16)), _rand(8, (2, 9, 4, 16))
    cpos = np.array([0, 1, 2, 3, 4, 5, -1, -1, -1], np.int32)
    want = rattn.decode_attention(_jax_tree(lp), jnp.asarray(x),
                                  jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(cpos), jnp.asarray(5), rcfg)
    tlp = {k: torch.from_numpy(v) for k, v in lp.items()}
    got = tattn.decode_attention(tlp, torch.from_numpy(x),
                                 torch.from_numpy(kc), torch.from_numpy(vc),
                                 torch.from_numpy(cpos), 5, tcfg)
    _close(got, want, rtol=2e-5, atol=2e-5)
    k1r, v1r = rattn.decode_kv(_jax_tree(lp), jnp.asarray(x),
                               jnp.asarray(5), rcfg)
    k1t, v1t = tattn.decode_kv(tlp, torch.from_numpy(x), 5, tcfg)
    _close(k1t, k1r, rtol=2e-5, atol=2e-5)
    _close(v1t, v1r, rtol=2e-5, atol=2e-5)


def test_quantize_kv_matches_reference():
    x = _rand(9, (2, 3, 4, 16))
    qr, sr = rattn.quantize_kv(jnp.asarray(x))
    qt, st = tattn.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(st.float().numpy(),
                                  np.asarray(sr, np.float32))
    _close(tattn.dequantize_kv(qt, st, torch.float32),
           rattn.dequantize_kv(qr, sr, jnp.float32), rtol=0, atol=0)


# ------------------------------------------------------------------- MoE


@pytest.fixture(scope="module")
def moe_setup():
    _need_reference()
    rcfg, tcfg = _cfg("moe", moe_shared=0, moe_capacity_factor=8.0)
    tree = convert.numpy_params(tcfg, 0)
    lp = jax.tree.map(lambda a: a[0], tree["layers"])["moe"]
    x = _rand(1, (96, 64))
    return (rcfg, tcfg, _jax_tree(lp),
            {k: torch.from_numpy(v) for k, v in lp.items()}, x)


def test_router_probs_with_pad_experts_match_reference():
    rcfg, tcfg = _cfg("moe", moe_experts=6, tp_divisor=4)
    assert tcfg.moe_experts_eff == 8
    lp = jax.tree.map(lambda a: a[0],
                      convert.numpy_params(tcfg, 1)["layers"])["moe"]
    x = _rand(2, (64, 64))
    wr, ir, ar = rmoe.router_probs(_jax_tree(lp), jnp.asarray(x), rcfg)
    wt, it, at = tmoe.router_probs(
        {"router": torch.from_numpy(lp["router"])}, torch.from_numpy(x),
        tcfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ir))
    assert int(it.max()) < 6
    _close(wt, wr, rtol=1e-5, atol=1e-6)
    _close(at, ar, rtol=1e-5, atol=1e-6)


def test_top_k_orders_ties_by_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    w, idx = tmoe._top_k(probs, 3)
    wr, ir = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ir).tolist() == [[1, 2, 4]]
    _close(w, wr, rtol=0, atol=0)


@pytest.mark.parametrize("t,k,e,block,seed", [
    (4, 2, 4, 4, 0), (12, 4, 64, 128, 1), (31, 4, 64, 128, 2),
    (96, 2, 8, 64, 3), (5, 3, 6, 8, 4)])
def test_sort_by_expert_matches_reference(t, k, e, block, seed):
    """Exact, ties included: many assignments share an expert."""
    idx = np.random.default_rng(seed).integers(0, min(e, 6), size=(t, k))
    ro, rd, rb, rt = rmoe.sort_by_expert(jnp.asarray(idx), e, block)
    to, td, tb, tt = tmoe.sort_by_expert(torch.from_numpy(idx), e, block)
    assert tt == rt
    np.testing.assert_array_equal(to.numpy(), np.asarray(ro))
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
    assert tb.dtype == torch.int32


@pytest.mark.parametrize("t,k,e,block,seed", [
    (4, 2, 4, 4, 0), (12, 4, 64, 128, 1), (31, 4, 64, 128, 2),
    (96, 2, 8, 64, 3), (5, 3, 6, 8, 4), (4, 4, 64, 128, 5)])
def test_group_rows_matches_reference_sort(t, k, e, block, seed):
    """group_rows is the end of the reference's last padded group: the
    first multiple of `block` past every ``dest`` of its sort_by_expert,
    and the sum of its padded group sizes. Every dest lies below it, and
    each block below it belongs to a group of the reference's map."""
    idx = np.random.default_rng(seed).integers(0, min(e, 6), size=(t, k))
    _, rd, rb, rt = rmoe.sort_by_expert(jnp.asarray(idx), e, block)
    rd, rb = np.asarray(rd), np.asarray(rb)
    ends = -(-(int(rd.max()) + 1) // block) * block
    sizes = np.bincount(idx.reshape(-1), minlength=e)
    assert ends == int((-(-sizes // block) * block).sum())
    got = tmoe.group_rows(torch.from_numpy(idx), e, block)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == ends <= rt
    assert bool((torch.from_numpy(rd.astype(np.int64)) < got).all())
    assert set(rb[:ends // block].tolist()) == set(idx.reshape(-1).tolist())


@pytest.mark.parametrize("dispatch", ["sw_plus64", "sw_plus128", "lw_plus",
                                      "oracle"])
def test_dispatch_matches_reference(moe_setup, dispatch):
    rcfg, tcfg, rp, tp, x = moe_setup
    if dispatch.startswith("sw_plus"):
        block = int(dispatch[7:])
        yr, ar = rmoe.dispatch_sw_plus(rp, jnp.asarray(x), rcfg, block=block)
        yt, at = tmoe.dispatch_sw_plus(tp, torch.from_numpy(x), tcfg,
                                       block=block)
    elif dispatch == "lw_plus":
        yr, ar = rmoe.dispatch_lw_plus(rp, jnp.asarray(x), rcfg)
        yt, at = tmoe.dispatch_lw_plus(tp, torch.from_numpy(x), tcfg)
    else:
        yr, ar = rmoe.dispatch_dense_oracle(rp, jnp.asarray(x), rcfg)
        yt, at = tmoe.dispatch_dense_oracle(tp, torch.from_numpy(x), tcfg)
    _close(yt, yr, **MOE_TOL)
    _close(at, ar, rtol=1e-5, atol=1e-6)
    # and the port's dispatches agree with the port's own oracle
    yo, _ = tmoe.dispatch_dense_oracle(tp, torch.from_numpy(x), tcfg)
    _close(yt, yo, **MOE_TOL)


def test_lw_plus_capacity_drops_match_reference():
    rcfg, tcfg = _cfg("moe", moe_shared=0, moe_capacity_factor=0.25)
    lp = jax.tree.map(lambda a: a[0],
                      convert.numpy_params(tcfg, 2)["layers"])["moe"]
    x = _rand(3, (128, 64))
    yr, _ = rmoe.dispatch_lw_plus(_jax_tree(lp), jnp.asarray(x), rcfg)
    yt, _ = tmoe.dispatch_lw_plus(
        {k: torch.from_numpy(v) for k, v in lp.items()},
        torch.from_numpy(x), tcfg)
    _close(yt, yr, **MOE_TOL)


@pytest.mark.parametrize("dispatch", ["sw_plus", "lw_plus"])
def test_moe_layer_with_shared_experts_matches_reference(dispatch):
    rcfg, tcfg = _cfg("moe", moe_dispatch=dispatch, moe_capacity_factor=8.0)
    tree = convert.numpy_params(tcfg, 3)
    lp = jax.tree.map(lambda a: a[0], tree["layers"])["moe"]
    x = _rand(4, (2, 24, 64))
    yr, ar = rmoe.moe_layer(_jax_tree(lp), jnp.asarray(x), rcfg)
    tlp = convert.params_from_numpy(tree, tcfg, "cpu")
    yt, at = tmoe.moe_layer(tmodel.layer_params(tlp, 0)["moe"],
                            torch.from_numpy(x), tcfg)
    _close(yt, yr, **MOE_TOL)
    _close(at, ar, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------- model: prefill/decode


@pytest.mark.parametrize("dispatch,kv", [("sw_plus", "model"),
                                         ("lw_plus", "model"),
                                         ("sw_plus", "int8")])
def test_prefill_and_decode_match_reference(dispatch, kv):
    rcfg, tcfg = _golden_cfgs()
    rcfg = dataclasses.replace(rcfg, moe_dispatch=dispatch,
                               kv_cache_dtype=kv)
    tcfg = dataclasses.replace(tcfg, moe_dispatch=dispatch,
                               kv_cache_dtype=kv)
    tree = convert.numpy_params(tcfg, 0)
    rp, tp = _jax_tree(tree), convert.params_from_numpy(tree, tcfg, "cpu")
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size,
                                             size=(2, 12))
    lr, cr = rmodel.prefill(rp, rcfg, {"tokens": jnp.asarray(toks[:, :7])},
                            max_len=16)
    lt, ct = tmodel.prefill(tp, tcfg, {"tokens": torch.from_numpy(
        toks[:, :7])}, max_len=16)
    _close(lt, lr, **LOGIT_TOL)
    np.testing.assert_array_equal(ct["kv"]["positions"].numpy(),
                                  np.asarray(cr["kv"]["positions"]))
    assert ct["kv"]["index"] == int(cr["kv"]["index"]) == 7
    for t in range(7, 12):
        lr, cr = rmodel.decode_step(rp, rcfg, jnp.asarray(toks[:, t:t + 1]),
                                    cr)
        lt, ct = tmodel.decode_step(tp, tcfg, torch.from_numpy(
            toks[:, t:t + 1]), ct)
        _close(lt, lr, **LOGIT_TOL)
        assert ct["kv"]["index"] == int(cr["kv"]["index"])
    _close(ct["kv"]["k"] if kv == "model" else ct["kv"]["k_scale"].float(),
           cr["kv"]["k"] if kv == "model" else cr["kv"]["k_scale"],
           rtol=2e-2 if kv == "int8" else 1e-4, atol=1e-4)


def test_forward_hidden_matches_reference():
    rcfg, tcfg = _cfg("moe", moe_dispatch="sw_plus")
    tree = convert.numpy_params(tcfg, 4)
    toks = np.random.default_rng(6).integers(0, 128, size=(2, 10))
    rp, tp = _jax_tree(tree), convert.params_from_numpy(tree, tcfg, "cpu")
    xr = rmodel.embed_inputs(rp, rcfg, {"tokens": jnp.asarray(toks)})
    xt = tmodel.embed_inputs(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    hr, ar = rmodel.forward_hidden(rp, rcfg, xr, jnp.arange(10))
    ht, at = tmodel.forward_hidden(tp, tcfg, xt, torch.arange(10))
    _close(ht, hr, **LOGIT_TOL)
    _close(at, ar, rtol=1e-5, atol=1e-6)
    _close(tmodel.logits_fn(tp, tcfg, ht), rmodel.logits_fn(rp, rcfg, hr),
           **LOGIT_TOL)


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen3-8b"])
def test_dense_smoke_archs_decode_match_reference(arch):
    """GELU + sinusoidal positions (musicgen) and qk-norm + GQA (qwen3)."""
    over = dict(dtype="float32")
    rcfg = dataclasses.replace(rregistry.get_config(arch, True), **over)
    tcfg = dataclasses.replace(tregistry.get_config(arch, True), **over)
    tree = convert.numpy_params(tcfg, 0)
    rp, tp = _jax_tree(tree), convert.params_from_numpy(tree, tcfg, "cpu")
    toks = np.random.default_rng(7).integers(0, 128, size=(1, 9))
    lr, cr = rmodel.prefill(rp, rcfg, {"tokens": jnp.asarray(toks[:, :6])},
                            max_len=12)
    lt, ct = tmodel.prefill(tp, tcfg, {"tokens": torch.from_numpy(
        toks[:, :6])}, max_len=12)
    _close(lt, lr, **LOGIT_TOL)
    for t in range(6, 9):
        lr, cr = rmodel.decode_step(rp, rcfg, jnp.asarray(toks[:, t:t + 1]),
                                    cr)
        lt, ct = tmodel.decode_step(tp, tcfg, torch.from_numpy(
            toks[:, t:t + 1]), ct)
        _close(lt, lr, **LOGIT_TOL)


# ------------------------------------------------------------- serving


def _record(server, log, to_np):
    """Wrap a server's prefill/decode callables to log their logits."""
    prefill, decode = server._prefill, server._decode

    def pre(p, b):
        logits, cache = prefill(p, b)
        log.append(("prefill", to_np(logits)))
        return logits, cache

    def dec(p, t, c):
        logits, cache = decode(p, t, c)
        log.append(("decode", to_np(logits)))
        return logits, cache

    server._prefill, server._decode = pre, dec


def reference_serve() -> dict:
    """The reference's smoke serve of :data:`GOLDEN_SERVE` on numpy-seeded
    weights: prompts, generated tokens, and every prefill/decode step's
    logits over the real vocabulary."""
    g = GOLDEN_SERVE
    rcfg, tcfg = _golden_cfgs()
    tree = convert.numpy_params(tcfg, g["seed"])
    reqs = [rserve.Request(r.rid, r.prompt, r.max_new) for r in
            tserve.make_requests(tcfg, g["requests"], g["max_new"],
                                 g["seed"])]
    server = rserve.BatchedServer(rcfg, _jax_tree(tree), g["slots"],
                                  g["max_len"])
    log = []
    _record(server, log, lambda a: np.asarray(a, np.float32))
    stats = server.run(reqs)
    v = rcfg.vocab_size
    return {
        "serve": dict(g),
        "prompts": [r.prompt.tolist() for r in reqs],
        "tokens": [r.generated for r in reqs],
        "decode_steps": stats["decode_steps"],
        "steps": [{"kind": kind, "logits": [[float(f"{x:.8g}") for x in row]
                                            for row in lg[:, :v].tolist()]}
                  for kind, lg in log],
    }


def port_serve(device="cpu"):
    """The port's run of the same smoke serve; returns (tokens, stats,
    [(kind, logits)])."""
    g = GOLDEN_SERVE
    tcfg = _port_golden_cfg()
    tp = convert.params_from_numpy(convert.numpy_params(tcfg, g["seed"]),
                                   tcfg, device)
    reqs = tserve.make_requests(tcfg, g["requests"], g["max_new"], g["seed"])
    server = tserve.BatchedServer(tcfg, tp, g["slots"], g["max_len"],
                                  device=device)
    log = []
    _record(server, log, lambda t: t.float().cpu().numpy())
    stats = server.run(reqs)
    return [r.generated for r in reqs], stats, log


@pytest.fixture(scope="module")
def golden_blob():
    _need_reference()
    return reference_serve()


def test_serve_matches_reference(golden_blob):
    _check_against_golden(golden_blob, *port_serve("cpu"))


def _check_against_golden(blob, tokens, stats, log):
    assert tokens == blob["tokens"]
    assert stats["decode_steps"] == blob["decode_steps"] == 15
    assert stats["requests"] == 5
    assert [k for k, _ in log] == [s["kind"] for s in blob["steps"]]
    v = _port_golden_cfg().vocab_size
    for (_, got), want in zip(log, blob["steps"]):
        _close(got[:, :v], np.asarray(want["logits"]), **LOGIT_TOL)
        assert (got[:, v:] == -1e9).all()


def test_golden_file_is_current(golden_blob):
    with open(GOLDEN_FILE, encoding="utf-8") as fh:
        assert json.load(fh) == golden_blob


def test_golden_logits_have_no_near_tie():
    """Every step's top two logits (all rows, empty slots included) differ
    by at least MIN_TOP2_GAP, a hundred times the logit tolerance."""
    with open(GOLDEN_FILE, encoding="utf-8") as fh:
        steps = json.load(fh)["steps"]
    gaps = [float(np.diff(np.sort(np.asarray(s["logits"]), -1)[:, -2:],
                          axis=-1).min()) for s in steps]
    assert min(gaps) >= MIN_TOP2_GAP, min(gaps)


def write_golden_file(path: str = GOLDEN_FILE) -> None:
    blob = reference_serve()
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(blob, fh, separators=(",", ":"))
        fh.write("\n")


def test_splice_cache_skips_positions_like_reference():
    """The reference's quirk, kept on purpose: only rank >= 3 arrays are
    spliced, so the prefill's positions (and index) stay behind."""
    tcfg = _port_golden_cfg()
    tp = convert.params_from_numpy(convert.numpy_params(tcfg, 0), tcfg,
                                   "cpu")
    server = tserve.BatchedServer(tcfg, tp, 2, 16, device="cpu")
    req = tserve.Request(0, np.arange(8, dtype=np.int32), 3)
    server._admit(req, 1)
    kv = server.cache["kv"]
    assert kv["positions"].tolist() == [-1] * 16 and kv["index"] == 0
    assert bool(kv["k"][:, 1, :8].abs().sum() > 0)
    assert bool((kv["k"][:, 1, 8:] == 0).all())
    assert bool((kv["k"][:, 0] == 0).all())


def test_serve_path_goes_through_kernel_ops(monkeypatch):
    """On the CPU the sw_plus serve path calls ops.coalesced_gather once
    and ops.moe_gmm three times per layer of every forward."""
    calls = {"gather": 0, "gmm": 0}
    gather, gmm = tops.coalesced_gather, tops.moe_gmm

    def count_gather(*a, **kw):
        calls["gather"] += 1
        return gather(*a, **kw)

    def count_gmm(*a, **kw):
        calls["gmm"] += 1
        return gmm(*a, **kw)

    monkeypatch.setattr(tops, "coalesced_gather", count_gather)
    monkeypatch.setattr(tops, "moe_gmm", count_gmm)
    tcfg = _port_golden_cfg()
    tp = tmodel.init_params(tcfg, 0, "cpu")
    reqs = tserve.make_requests(tcfg, 3, 4, seed=1)
    stats = tserve.BatchedServer(tcfg, tp, 2, 48, device="cpu").run(reqs)
    forwards = stats["requests"] + stats["decode_steps"]   # one prefill each
    assert calls == {"gather": tcfg.n_layers * forwards,
                     "gmm": 3 * tcfg.n_layers * forwards}


def test_serve_main_on_cpu(capsys):
    stats = tserve.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device",
                         "cpu", "--requests", "3", "--max-new", "4"])
    assert stats["requests"] == 3 and stats["total_new_tokens"] == 12
    assert json.loads(capsys.readouterr().out.strip()) == stats


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tcfg = _port_golden_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(tcfg, 0)
    tp = tmodel.init_params(tcfg, 0, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.BatchedServer(tcfg, tp, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy(convert.numpy_params(tcfg, 0), tcfg)


def test_resolve_device():
    assert tmodel.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tmodel.resolve_device("meta")


def test_serve_cli_defaults_to_card():
    src = open(tserve.__file__, encoding="utf-8").read()
    calls = [n for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
             == "add_argument" and n.args[0].value == "--device"]
    assert [kw.value.value for kw in calls[0].keywords
            if kw.arg == "default"] == ["cuda"]


# ---------------------------------------------------------------- convert


def test_params_from_numpy_round_trip():
    """The reference's own bf16 weights carry over bit for bit (router in
    float32), and numpy_params has the reference's tree and shapes."""
    rcfg = rregistry.get_config("qwen2-moe-a2.7b", smoke=True)
    tcfg = tregistry.get_config("qwen2-moe-a2.7b", smoke=True)
    rp = rmodel.init_params(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree.map(np.asarray, rp)
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    flat_r = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat_r:
        node = tp
        for key in path:
            node = node[key.key]
        if leaf.dtype == np.float32:
            assert node.dtype == torch.float32
            np.testing.assert_array_equal(node.numpy(), leaf)
        else:
            assert node.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                          leaf.view(np.int16))
    shapes_r = jax.tree.map(np.shape, tree)
    shapes_t = jax.tree.map(np.shape, convert.numpy_params(tcfg, 0))
    assert shapes_t == shapes_r
    t_init = tmodel.init_params(tcfg, 0, "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), t_init,
                        is_leaf=lambda x: isinstance(x, torch.Tensor)) \
        == shapes_r
    bad = jax.tree.map(lambda a: a, tree)
    bad["embed"] = bad["embed"][:, :10]
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_numpy(bad, tcfg, "cpu")


def test_init_is_seeded_and_scaled():
    tcfg = _port_golden_cfg()
    a = tmodel.init_params(tcfg, 3, "cpu")
    b = tmodel.init_params(tcfg, 3, "cpu")
    c = tmodel.init_params(tcfg, 4, "cpu")
    assert torch.equal(a["layers"]["moe"]["w1"], b["layers"]["moe"]["w1"])
    assert not torch.equal(a["embed"], c["embed"])
    w1 = a["layers"]["moe"]["w1"]
    assert float(w1.abs().max()) <= 2.0 / tcfg.d_model ** 0.5 + 1e-6
    assert abs(float(w1.std()) * tcfg.d_model ** 0.5 - 0.88) < 0.05


def test_port_sources_spell_no_env_knobs():
    """The port reads the environment only through its registry of the
    reference's service names (``core/warpsim/envcfg.py``, no kill
    switch), and the service smoke copies it only to configure the
    daemons and figure runs it starts (``child_env``)."""
    port = os.path.join(REPO, "src", "repro_torch")
    allowed = {os.path.join("core", "warpsim", "envcfg.py"),
               os.path.join("benchmarks", "service_smoke.py")}
    for root, _dirs, files in os.walk(port):
        for name in files:
            if name.endswith((".py", ".cu")):
                path = os.path.join(root, name)
                with open(path, encoding="utf-8") as fh:
                    text = fh.read()
                rel = os.path.relpath(path, port)
                if rel not in allowed:
                    assert "os.environ" not in text, rel
                    assert "getenv" not in text, rel
    with open(os.path.join(port, "core", "warpsim", "envcfg.py"),
              encoding="utf-8") as fh:
        text = fh.read()
    assert text.count("os.environ") == 1
    assert "os.environ.get(var.name, var.default)" in text
    with open(os.path.join(port, "benchmarks", "service_smoke.py"),
              encoding="utf-8") as fh:
        text = fh.read()
    assert text.count("os.environ") == 1
    assert "    env = dict(os.environ)\n" in text.split("def child_env")[1]


def test_port_modules_import_without_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.launch.serve, repro_torch.models.convert, "
            "repro_torch.benchmarks.kernel_bench; "
            "print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


# --------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_serve_on_card_matches_golden_file(card):
    """The smoke serve through K3 and K4 on the card, against the
    reference's tokens and logits kept in the golden file."""
    from repro_torch import kernels
    with open(GOLDEN_FILE, encoding="utf-8") as fh:
        blob = json.load(fh)
    kernels.reset_launch_counts()
    tokens, stats, log = port_serve(card)
    torch.cuda.synchronize()
    _check_against_golden(blob, tokens, stats, log)
    forwards = stats["requests"] + stats["decode_steps"]
    n_layers = _port_golden_cfg().n_layers
    assert kernels.launch_count("gather_rows_kernel") == n_layers * forwards
    assert kernels.launch_count("gmm_kernel") == 3 * n_layers * forwards


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-golden"]:
        write_golden_file()
        print(f"wrote {GOLDEN_FILE}")
    else:
        sys.exit("usage: python tests/test_torch_models.py --write-golden")
