"""The port's Mamba2 block, the ``ssm`` and ``hybrid`` families, their
serve path and the port's ``kernel_bench``, held against the reference.

The same inputs and weights, drawn with numpy (``repro_torch.models.
convert``), go through both packages; JAX runs on the CPU. Tolerances,
each with its reason:

* rtol 1e-5, atol 1e-6 (:data:`TOL`) for the convolution, segsum, the
  chunked scan (``y`` and ``h_final``, padding quirk included) and the
  sequential oracle: float32 sums in another order.
* Logits of prefill, decode and serving: rtol 1e-4, atol 1e-4
  (``LOGIT_TOL``, as in ``tests/test_torch_models.py``): a wrong state row
  or a missed decay moves logits far outside it.
* Exact: configs, served tokens, cache splicing, weights carried through
  ``convert``.

Regenerate the golden files of the two smoke serves (which
``chip_smoke.py`` checks the card against) with
``PYTHONPATH=src:tests python tests/test_torch_ssm.py --write-golden``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import kernel_bench as tbench
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as rregistry
    from repro.kernels import ref as rref
    from repro.launch import serve as rserve
    from repro.models import model as rmodel
    from repro.models import ssm as rssm
except ImportError:     # a machine with a card and no jax: gpu tests only
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "src", "repro_torch", "models", "data")
TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MIN_TOP2_GAP = 1e-3
# The smoke serves the golden files hold and chip_smoke.py replays. Seeds
# for weights and prompts: the ones of 0-11 with the widest smallest gap
# between any step's two largest logits (mamba2: 7, 3.2e-3; hymba: 6,
# 5.3e-3; test_golden_logits_have_no_near_tie), so float32 sums in
# another order cannot flip a token. hymba's chunk is 16, so its prompts
# of 21, 23 and 25 tokens go through the padding quirk of ssm.ssd_scan.
GOLDEN = {
    "mamba2-780m": ("serve_golden_mamba2_smoke.json",
                    dict(arch="mamba2-780m", smoke=True, dtype="float32",
                         seed=7, requests=5, slots=2, max_new=6,
                         max_len=64)),
    "hymba-1.5b": ("serve_golden_hymba_smoke.json",
                   dict(arch="hymba-1.5b", smoke=True, dtype="float32",
                        seed=6, requests=5, slots=2, max_new=6,
                        max_len=64)),
}
ARCHS = list(GOLDEN)


def _need_reference():
    if jax is None:
        pytest.skip("needs jax, the reference package's framework")


@pytest.fixture(autouse=True)
def _reference(request):
    """Every test but the ``gpu`` ones needs the reference (jax)."""
    if request.node.get_closest_marker("gpu") is None:
        _need_reference()


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _cfgs(arch, **over):
    over = {"dtype": "float32", **over}
    return (dataclasses.replace(rregistry.get_config(arch, True), **over),
            dataclasses.replace(tregistry.get_config(arch, True), **over))


def _layer_tree(tcfg, seed):
    """Layer 0's SSM parameters as numpy, with A_log, D, dt_bias and the
    conv biases drawn too (the init makes them constants)."""
    tree = convert.numpy_params(tcfg, seed)["layers"]["ssm"]
    lp = {k: v[0] for k, v in tree.items()}
    rng = np.random.default_rng(seed + 100)
    nh = tcfg.ssm_heads
    lp["A_log"] = rng.uniform(-1.0, 1.5, nh).astype(np.float32)
    lp["D"] = rng.uniform(0.5, 1.5, nh).astype(np.float32)
    lp["dt_bias"] = rng.uniform(-1.0, 0.5, nh).astype(np.float32)
    lp["conv_x_b"] = _rand(seed + 101, lp["conv_x_b"].shape, 0.1)
    lp["conv_bc_b"] = _rand(seed + 102, lp["conv_bc_b"].shape, 0.1)
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            {k: _t(v) for k, v in lp.items()})


# ------------------------------------------------------ scan and oracles


def _scan_inputs(bsz, s, nh, p, g, n, seed=0):
    x = _rand(seed, (bsz, s, nh, p), 0.5)
    dt = _rand(seed + 1, (bsz, s, nh))
    a_log = _rand(seed + 2, (nh,), 0.5)
    b = _rand(seed + 3, (bsz, s, g, n), 0.3)
    c = _rand(seed + 4, (bsz, s, g, n), 0.3)
    d = _rand(seed + 5, (nh,))
    return x, dt, a_log, b, c, d


def test_ssd_chunk_ref_matches_reference():
    x, dt, a_log, b, c, d = _scan_inputs(2, 24, 3, 8, 3, 5)
    yr, hr = rref.ssd_chunk_ref(*map(jnp.asarray, (x, dt, a_log, b, c, d)),
                                chunk=8)
    yt, ht = tref.ssd_chunk_ref(*map(_t, (x, dt, a_log, b, c, d)), chunk=8)
    _close(yt, yr, **TOL)
    _close(ht, hr, **TOL)


@pytest.mark.parametrize("s,chunk,with_h0", [
    (64, 16, False),     # S a multiple of the chunk
    (40, 40, False),     # one chunk
    (40, 16, False),     # padded to 48: the h_final quirk
    (40, 16, True),      # padded, from a given state
    (37, 64, True),      # S below the chunk: one chunk of S, no padding
])
def test_ssd_scan_matches_reference(s, chunk, with_h0):
    x, dt, a_log, b, c, d = _scan_inputs(2, s, 4, 8, 2, 6, seed=s)
    h0 = _rand(7, (2, 4, 8, 6)) if with_h0 else None
    yr, hr = rssm.ssd_scan(*map(jnp.asarray, (x, dt, a_log, b, c, d)),
                           chunk=chunk,
                           h0=None if h0 is None else jnp.asarray(h0))
    yt, ht = tssm.ssd_scan(*map(_t, (x, dt, a_log, b, c, d)), chunk=chunk,
                           h0=None if h0 is None else _t(h0))
    assert yt.dtype == torch.float32 and ht.shape == (2, 4, 8, 6)
    _close(yt, yr, **TOL)
    _close(ht, hr, **TOL)


def test_ssd_scan_padding_quirk_is_kept():
    """Padding S = 40 up to 48 with dt = 0 still decays the state
    (softplus(0) = ln 2): y agrees with the unpadded scan, h_final does
    not, in both packages alike."""
    x, dt, a_log, b, c, d = _scan_inputs(1, 40, 2, 4, 1, 3, seed=3)
    args_t = tuple(map(_t, (x, dt, a_log, b, c, d)))
    y16, h16 = tssm.ssd_scan(*args_t, chunk=16)
    y40, h40 = tssm.ssd_scan(*args_t, chunk=40)
    y8, h8 = tssm.ssd_scan(*args_t, chunk=8)
    _close(y16, y40.numpy(), rtol=1e-4, atol=1e-5)
    _close(h8, h40.numpy(), rtol=1e-4, atol=1e-6)
    assert float((h16 - h40).abs().max()) > 0.5 * float(h40.abs().max())
    _, hr = rssm.ssd_scan(*map(jnp.asarray, (x, dt, a_log, b, c, d)),
                          chunk=16)
    _close(h16, hr, **TOL)


def test_ssd_scan_matches_sequential_oracle():
    """The model's chunked scan against the sequential recurrence."""
    x, dt, a_log, b, c, d = _scan_inputs(2, 48, 3, 8, 3, 5, seed=9)
    yt, ht = tssm.ssd_scan(*map(_t, (x, dt, a_log, b, c, d)), chunk=16)
    ys, hs = tref.ssd_chunk_ref(*map(_t, (x, dt, a_log, b, c, d)), chunk=16)
    _close(yt, ys.numpy(), rtol=1e-4, atol=1e-5)
    _close(ht, hs.numpy(), rtol=1e-4, atol=1e-5)


def test_segsum_matches_reference():
    a = -np.abs(_rand(11, (2, 3, 12)))
    got = tssm._segsum(_t(a)).numpy()
    want = np.asarray(rssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    x = _rand(12, (2, 9, 6))
    w = _rand(13, (4, 6), 0.5)
    b = _rand(14, (6,), 0.1)
    st = _rand(15, (2, 3, 6)) if with_state else None
    yr, sr = rssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    yt, stt = tssm._causal_conv(_t(x), _t(w), _t(b),
                                None if st is None else _t(st))
    _close(yt, yr, **TOL)
    _close(stt, sr, **TOL)


# ------------------------------------------------------------- the block


@pytest.mark.parametrize("arch,s", [("mamba2-780m", 40),
                                    ("hymba-1.5b", 23),
                                    ("hymba-1.5b", 2)])
def test_ssm_layer_with_cache_matches_reference(arch, s):
    """Prompts longer than the chunk (padded), and shorter than the conv
    window (the cached tail is left-padded)."""
    rcfg, tcfg = _cfgs(arch)
    rp, tp = _layer_tree(tcfg, 1)
    xin = _rand(16, (2, s, tcfg.d_model))
    outr = rssm.ssm_layer(rp, jnp.asarray(xin), rcfg, return_cache=True)
    outt = tssm.ssm_layer(tp, _t(xin), tcfg, return_cache=True)
    for got, want in zip(outt, outr):
        assert tuple(got.shape) == want.shape
        _close(got, want, rtol=1e-4, atol=1e-5)
    _close(tssm.ssm_layer(tp, _t(xin), tcfg), outr[0], rtol=1e-4,
           atol=1e-5)


def test_ssm_decode_step_matches_reference():
    rcfg, tcfg = _cfgs("mamba2-780m")
    rp, tp = _layer_tree(tcfg, 2)
    xin = _rand(17, (3, 1, tcfg.d_model))
    cx = _rand(18, (3, tcfg.ssm_conv - 1, tcfg.d_inner))
    cbc = _rand(19, (3, tcfg.ssm_conv - 1, 2 * tcfg.ssm_state))
    h = _rand(20, (3, tcfg.ssm_heads, tcfg.ssm_headdim, tcfg.ssm_state))
    outr = rssm.ssm_decode_step(rp, *map(jnp.asarray, (xin, cx, cbc, h)),
                                rcfg)
    outt = tssm.ssm_decode_step(tp, *map(_t, (xin, cx, cbc, h)), tcfg)
    for got, want in zip(outt, outr):
        _close(got, want, rtol=1e-4, atol=1e-5)


def test_init_ssm_cache_matches_reference():
    rcfg, tcfg = _cfgs("hymba-1.5b", dtype="bfloat16")
    r = rssm.init_ssm_cache(rcfg, 3, jnp.bfloat16)
    t = tssm.init_ssm_cache(tcfg, 3, torch.bfloat16, "cpu")
    assert {k: tuple(v.shape) for k, v in t.items()} == \
        {k: v.shape for k, v in r.items()}
    assert t["h"].dtype == torch.float32
    assert t["conv_x"].dtype == torch.bfloat16


# ----------------------------------------------------- families end to end


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(arch):
    rcfg, tcfg = _cfgs(arch)
    tree = convert.numpy_params(tcfg, 3)
    rp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size,
                                             size=(2, 20))
    xr = rmodel.embed_inputs(rp, rcfg, {"tokens": jnp.asarray(toks)})
    xt = tmodel.embed_inputs(tp, tcfg, {"tokens": _t(toks)})
    hr, ar = rmodel.forward_hidden(rp, rcfg, xr, jnp.arange(20))
    ht, at = tmodel.forward_hidden(tp, tcfg, xt, torch.arange(20))
    _close(ht, hr, **LOGIT_TOL)
    assert float(at) == float(ar) == 0.0


@pytest.mark.parametrize("arch,prompt", [("mamba2-780m", 11),
                                         ("mamba2-780m", 45),
                                         ("hymba-1.5b", 23)])
def test_prefill_and_decode_match_reference(arch, prompt):
    """45 tokens at mamba2's chunk 32 and 23 at hymba's 16 are padded:
    decode starts from the quirky h_final in both packages."""
    rcfg, tcfg = _cfgs(arch)
    tree = convert.numpy_params(tcfg, 0)
    rp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size,
                                             size=(2, prompt + 5))
    lr, cr = rmodel.prefill(rp, rcfg, {"tokens": jnp.asarray(
        toks[:, :prompt])}, max_len=64)
    lt, ct = tmodel.prefill(tp, tcfg, {"tokens": _t(toks[:, :prompt])},
                            max_len=64)
    _close(lt, lr, **LOGIT_TOL)
    assert set(ct) == set(cr)
    for key in ("conv_x", "conv_bc", "h"):
        _close(ct["ssm"][key], cr["ssm"][key], rtol=1e-4, atol=1e-5)
    for t in range(prompt, prompt + 5):
        lr, cr = rmodel.decode_step(rp, rcfg, jnp.asarray(toks[:, t:t + 1]),
                                    cr)
        lt, ct = tmodel.decode_step(tp, tcfg, _t(toks[:, t:t + 1]), ct)
        _close(lt, lr, **LOGIT_TOL)
    _close(ct["ssm"]["h"], cr["ssm"]["h"], rtol=1e-4, atol=1e-5)
    if "kv" in cr:
        assert ct["kv"]["index"] == int(cr["kv"]["index"]) == prompt + 5


# ---------------------------------------------------------------- convert


def test_params_from_numpy_carries_ssm_leaves():
    """The reference's own bf16 hymba weights carry over bit for bit, with
    A_log, D and dt_bias in float32; numpy_params has the reference's tree
    and shapes."""
    rcfg = rregistry.get_config("hymba-1.5b", smoke=True)
    tcfg = tregistry.get_config("hymba-1.5b", smoke=True)
    tree = jax.tree.map(np.asarray,
                        rmodel.init_params(jax.random.PRNGKey(0), rcfg))
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = tp
        for key in path:
            node = node[key.key]
        if leaf.dtype == np.float32:
            assert node.dtype == torch.float32, path
            np.testing.assert_array_equal(node.numpy(), leaf)
        else:
            assert node.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                          leaf.view(np.int16))
    for name in ("A_log", "D", "dt_bias"):
        assert tp["layers"]["ssm"][name].dtype == torch.float32
    assert jax.tree.map(np.shape, convert.numpy_params(tcfg, 0)) == \
        jax.tree.map(np.shape, tree)
    t_init = tmodel.init_params(tcfg, 0, "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), t_init,
                        is_leaf=lambda x: isinstance(x, torch.Tensor)) \
        == jax.tree.map(np.shape, tree)
    np.testing.assert_array_equal(t_init["layers"]["ssm"]["A_log"].numpy(),
                                  tree["layers"]["ssm"]["A_log"])


# ---------------------------------------------------------------- serving


def test_splice_cache_splices_ssm_state_like_reference():
    """conv_x, conv_bc and h are rank >= 3 with layers first, so both
    packages splice them into the slot."""
    rcfg, tcfg = _cfgs("mamba2-780m")
    tree = convert.numpy_params(tcfg, 0)
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    server = tserve.BatchedServer(tcfg, tp, 3, 16, device="cpu")
    prompt = np.arange(1, 10, dtype=np.int32)
    server._admit(tserve.Request(0, prompt, 3), 1)
    rserver = rserve.BatchedServer(rcfg, jax.tree.map(jnp.asarray, tree), 3,
                                   16)
    rserver._admit(rserve.Request(0, prompt, 3), 1)
    assert set(server.cache) == set(rserver.cache) == {"ssm"}
    for key in ("conv_x", "conv_bc", "h"):
        got, want = server.cache["ssm"][key], rserver.cache["ssm"][key]
        _close(got, want, rtol=1e-4, atol=1e-5)
        assert bool(got[:, 1].abs().sum() > 0)
        assert bool((got[:, 0] == 0).all()) and bool((got[:, 2] == 0).all())


def _record(server, log, to_np):
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


def _serve_cfg(g, registry):
    return dataclasses.replace(registry.get_config(g["arch"], g["smoke"]),
                               dtype=g["dtype"])


def reference_serve(arch) -> dict:
    """The reference's smoke serve of ``GOLDEN[arch]`` on numpy-seeded
    weights: prompts, generated tokens, and every prefill/decode step's
    logits over the real vocabulary."""
    g = GOLDEN[arch][1]
    rcfg, tcfg = _serve_cfg(g, rregistry), _serve_cfg(g, tregistry)
    tree = convert.numpy_params(tcfg, g["seed"])
    reqs = [rserve.Request(r.rid, r.prompt, r.max_new) for r in
            tserve.make_requests(tcfg, g["requests"], g["max_new"],
                                 g["seed"])]
    server = rserve.BatchedServer(rcfg, jax.tree.map(jnp.asarray, tree),
                                  g["slots"], g["max_len"])
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


def port_serve(arch, device="cpu"):
    """The port's run of the same smoke serve; returns (tokens, stats,
    [(kind, logits)])."""
    g = GOLDEN[arch][1]
    tcfg = _serve_cfg(g, tregistry)
    tp = convert.params_from_numpy(convert.numpy_params(tcfg, g["seed"]),
                                   tcfg, device)
    reqs = tserve.make_requests(tcfg, g["requests"], g["max_new"], g["seed"])
    server = tserve.BatchedServer(tcfg, tp, g["slots"], g["max_len"],
                                  device=device)
    log = []
    _record(server, log, lambda t: t.float().cpu().numpy())
    stats = server.run(reqs)
    return [r.generated for r in reqs], stats, log


def _golden(arch):
    with open(os.path.join(DATA, GOLDEN[arch][0]), encoding="utf-8") as fh:
        return json.load(fh)


def _check_against_golden(arch, blob, tokens, stats, log):
    g = GOLDEN[arch][1]
    assert tokens == blob["tokens"]
    assert stats["decode_steps"] == blob["decode_steps"]
    assert stats["requests"] == g["requests"]
    assert [k for k, _ in log] == [s["kind"] for s in blob["steps"]]
    v = _serve_cfg(g, tregistry).vocab_size
    for (_, got), want in zip(log, blob["steps"]):
        _close(got[:, :v], np.asarray(want["logits"]), **LOGIT_TOL)
        assert (got[:, v:] == -1e9).all()


@pytest.fixture(scope="module")
def golden_blobs():
    _need_reference()
    return {arch: reference_serve(arch) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(golden_blobs, arch):
    _check_against_golden(arch, golden_blobs[arch], *port_serve(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_file_is_current(golden_blobs, arch):
    assert _golden(arch) == golden_blobs[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_logits_have_no_near_tie(arch):
    """Every step's top two logits (all rows, empty slots included) differ
    by at least MIN_TOP2_GAP, ten times the logit tolerance."""
    steps = _golden(arch)["steps"]
    gaps = [float(np.diff(np.sort(np.asarray(s["logits"]), -1)[:, -2:],
                          axis=-1).min()) for s in steps]
    assert min(gaps) >= MIN_TOP2_GAP, min(gaps)


def test_hymba_golden_prompts_take_the_padding_quirk():
    blob = _golden("hymba-1.5b")
    chunk = tregistry.get_config("hymba-1.5b", smoke=True).ssm_chunk
    assert any(len(p) > chunk and len(p) % chunk for p in blob["prompts"])


def write_golden_files() -> None:
    for arch, (name, _) in GOLDEN.items():
        with open(os.path.join(DATA, name), "w", encoding="utf-8") as fh:
            json.dump(reference_serve(arch), fh, separators=(",", ":"))
            fh.write("\n")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(capsys, arch):
    stats = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-new", "4"])
    assert stats["requests"] == 3 and stats["total_new_tokens"] == 12
    assert json.loads(capsys.readouterr().out.strip()) == stats


# ---------------------------------------------------------- kernel_bench


def test_kernel_bench_rows_on_cpu():
    """The port's kernel_bench at small sizes: the reference's row names
    for the two sweeps, one record row per LM kernel (K5, K4, K6)."""
    attn = tbench.attention_chunk_sweep("cpu", b=1, s=64, h=2, hd=16,
                                        chunks=(16, 64), iters=1)
    ssd = tbench.ssd_chunk_sweep("cpu", b=1, s=64, nh=2, p=8, n=4,
                                 chunks=(16, 32), iters=1)
    rec = tbench.kernel_record("cpu", ssd_shape=(2, 64, 8, 4), ssd_chunk=16)
    assert [r[0] for r in attn] == ["attn/kv_chunk=16", "attn/kv_chunk=64"]
    assert [r[0] for r in ssd] == ["ssd/chunk=16", "ssd/chunk=32"]
    assert [r[2] for r in ssd] == [16.0, 32.0]
    assert [r[0] for r in rec] == ["kernel/flash_attention",
                                   "kernel/moe_gmm", "kernel/ssd_scan"]
    assert all(r[1] > 0 and np.isfinite(r[1]) for r in attn + ssd + rec)


def test_kernel_bench_defaults_are_the_reference_shapes():
    import inspect
    sig = inspect.signature(tbench.attention_chunk_sweep).parameters
    assert [sig[k].default for k in ("b", "s", "h", "hd", "chunks")] == \
        [2, 2048, 4, 64, (128, 256, 512, 1024, 2048)]
    sig = inspect.signature(tbench.ssd_chunk_sweep).parameters
    assert [sig[k].default for k in ("b", "s", "nh", "p", "n", "chunks")] \
        == [2, 4096, 8, 64, 64, (64, 128, 256, 512)]


# --------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_card_matches_golden_file(card, arch):
    """The smoke serves on the card against the reference's tokens and
    logits kept in the golden files."""
    _check_against_golden(arch, _golden(arch), *port_serve(arch, card))


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-golden"]:
        write_golden_files()
        print(f"wrote {[name for name, _ in GOLDEN.values()]} in {DATA}")
    else:
        sys.exit("usage: python tests/test_torch_ssm.py --write-golden")
