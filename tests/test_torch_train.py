"""The port's training path held against the reference.

Inputs come from numpy seeds, weights go through
``convert.params_from_numpy``, and configs are float32 through
``dataclasses.replace`` unless a test says otherwise. JAX runs on the CPU.
Tolerances, each with its reason:

* Exact: the synthetic batches (both packages run the same numpy code),
  the straggler events and the failure injector, checkpoint bytes both
  ways, the port's kill/resume drill, the remat policies against each
  other (recomputing a layer repeats the same operations).
* AdamW, float32: params, moments, ``grad_norm`` and ``lr`` rtol 1e-6
  against the reference's ``apply`` as written (op by op; its jitted form
  differs from itself by fused roundings), with an atol of 1e-6 x the
  leaf's largest value where an update cancels to near zero. The global
  norm sums in XLA's order and ``cos``/``pow`` are XLA's, an ulp apart
  from PyTorch's. bf16: bit for bit during the warmup with unclipped
  gradients, where every input of the rounding has the same float32 bits
  in both packages; within one bf16 ulp once clipping and the cosine
  schedule carry those ulps into the float32 value before its rounding.
* ``train_loss`` and its grads, every arch at smoke size (B 2, S 32):
  loss rtol 1e-5; each grad leaf rtol 1e-4 with atol 1e-6 x the leaf's
  largest value, 6e-6 x for the ssm family: the port's largest gap
  from the reference's op-by-op gradients of mamba2's smoke config is
  5.38e-6 x the leaf's largest value (``layers/ssm/A_log``, the same at
  1 to 8 threads; the SSD chunk scan's backward sums through exp and
  cumsum in another order). The reference's own jitted and op-by-op
  gradients there differ by up to 8.5e-6 x, so 1e-6 is below what the
  reference agrees with itself to. The other families stay under 8.5e-7.
* Six accumulated train steps against the reference's jitted step:
  losses rtol 1e-4.
"""

import ast
import dataclasses
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as ttree
from repro_torch.benchmarks import train_smoke
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import registry as tregistry
from repro_torch.data import DataConfig as TDataConfig
from repro_torch.data import PrefetchLoader
from repro_torch.data import SyntheticCorpus as TCorpus
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.config import get_shape
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import fault as tfault
from repro_torch.runtime import straggler as tstraggler

try:
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from repro.checkpoint import ckpt as rckpt
    from repro.configs import registry as rregistry
    from repro.data import DataConfig as RDataConfig
    from repro.data import SyntheticCorpus as RCorpus
    from repro.launch import steps as rsteps
    from repro.launch import train as rtrain
    from repro.models import model as rmodel
    from repro.models import moe as rmoe
    from repro.optim import adamw as radamw
    from repro.runtime import fault as rfault
    from repro.runtime import straggler as rstraggler
except ImportError:     # a machine with a card and no jax: gpu tests only
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_FILE = os.path.join(REPO, "src", "repro_torch", "models", "data",
                           "serve_golden_qwen2moe_smoke.json")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = {"ssm": 6e-6}          # x the leaf's max; 1e-6 for the rest


def _need_reference():
    if jax is None:
        pytest.skip("needs jax, the reference package's framework")


@pytest.fixture(autouse=True)
def _reference(request):
    """Every test but the ``gpu`` ones needs the reference (jax)."""
    if request.node.get_closest_marker("gpu") is None:
        _need_reference()


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    r = dataclasses.replace(rregistry.get_config(arch, smoke=True), **kw)
    t = dataclasses.replace(tregistry.get_config(arch, smoke=True), **kw)
    return r, t


def _batch(cfg, step=0, batch=2, seq_len=32, seed=3):
    data = TCorpus(TDataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                               global_batch=batch, seed=seed))
    if cfg.frontend in ("audio", "vlm"):
        return data.embeds_at(step, cfg.d_model)
    return data.batch_at(step)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _to_jax(t):
    """A port tensor as a jax array of the same dtype and bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()
                           .view(ml_dtypes.bfloat16))
    return jnp.asarray(t.detach().numpy())


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("seed,host", [(0, 0), (1234, 0), (7, 1)])
def test_batches_equal_reference_bit_for_bit(seed, host):
    kw = dict(vocab_size=300, seq_len=48, global_batch=4, seed=seed,
              n_hosts=2, host_index=host)
    r, t = RCorpus(RDataConfig(**kw)), TCorpus(TDataConfig(**kw))
    for step in (0, 1, 17, 1000):
        rb, tb = r.batch_at(step), t.batch_at(step)
        for key in ("tokens", "labels"):
            assert tb[key].dtype == rb[key].dtype == np.int32
            np.testing.assert_array_equal(tb[key], rb[key])
        re, te = r.embeds_at(step, 24), t.embeds_at(step, 24)
        assert te["input_embeds"].dtype == np.float32
        np.testing.assert_array_equal(te["input_embeds"], re["input_embeds"])
        np.testing.assert_array_equal(te["labels"], re["labels"])


def test_prefetch_loader_yields_steps_in_order():
    corpus = TCorpus(TDataConfig(vocab_size=64, seq_len=8, global_batch=2))
    loader = PrefetchLoader(corpus.batch_at, start_step=5, device="cpu")
    try:
        for want in range(5, 9):
            step, batch = next(loader)
            assert step == want
            assert isinstance(batch["tokens"], torch.Tensor)
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          corpus.batch_at(step)["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()
    plain = PrefetchLoader(corpus.batch_at)
    try:
        step, batch = next(plain)
        assert step == 0 and isinstance(batch["tokens"], np.ndarray)
    finally:
        plain.close()


# --------------------------------------------------------------- AdamW


def test_schedule_matches_reference():
    rc = radamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=100)
    tc = tadamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=100)
    steps = np.arange(0, 121, dtype=np.int32)
    want = np.asarray(radamw.schedule(rc, jnp.asarray(steps)))
    got = tadamw.schedule(tc, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_decay_mask_matches_reference():
    """Weight decay on the same leaves of every arch's tree."""
    for arch in tregistry.list_archs():
        tree = convert.numpy_params(tregistry.get_config(arch, True), 0)
        for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
            names = tuple(p.key for p in path)
            assert tadamw._decay_mask(names) == radamw._decay_mask(path), (
                arch, names)


def _adamw_runs(dtype, grad_scales, warmup):
    """The same params, grads and state through both packages' ``apply``,
    one step per grad scale; yields (reference, port) after each."""
    _, tcfg = _cfgs("tinyllama-1.1b", dtype=dtype)
    tp = convert.params_from_numpy(convert.numpy_params(tcfg, 0), tcfg,
                                   "cpu")
    rp = ttree.map_leaves(_to_jax, tp)
    ropt, topt = radamw.init(rp), tadamw.init(tp)
    kw = dict(lr=1e-2, warmup_steps=warmup, total_steps=10)
    rc, tc = radamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    rng = np.random.default_rng(1)
    for scale in grad_scales:
        g = ttree.map_leaves(lambda p: (rng.standard_normal(tuple(p.shape))
                                        * scale).astype(np.float32), tp)
        tg = ttree.map_leaves(lambda a, p: torch.from_numpy(a).to(p.dtype),
                              g, tp)
        rg = ttree.map_leaves(_to_jax, tg)
        rp, ropt, rinfo = radamw.apply(rc, rg, ropt, rp)
        tp, topt, tinfo = tadamw.apply(tc, tg, topt, tp)
        yield (rp, ropt, rinfo), (tp, topt, tinfo)


def _close_f32(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def test_adamw_apply_matches_reference_float32():
    """Three steps, the second clipped (grad norm ~36), from the warmup
    into the cosine."""
    for (rp, ropt, rinfo), (tp, topt, tinfo) in _adamw_runs(
            "float32", (0.002, 0.1, 0.002), warmup=2):
        for key in ("grad_norm", "lr"):
            assert tinfo[key].dtype == torch.float32
            np.testing.assert_allclose(float(tinfo[key]),
                                       float(rinfo[key]), rtol=1e-6)
        assert topt["step"].dtype == torch.int32
        assert int(topt["step"]) == int(ropt["step"])
        for path, t in ttree.flatten(tp):
            assert t.dtype == torch.float32
            _close_f32(t, _at(rp, path))
            _close_f32(_at(topt["m"], path), _at(ropt["m"], path))
            _close_f32(_at(topt["v"], path), _at(ropt["v"], path))


def test_adamw_apply_matches_reference_bf16_bit_for_bit_in_warmup():
    """Unclipped gradients during the warmup: the rounding's inputs agree
    bit for bit, so every bf16 parameter does too."""
    for (rp, ropt, rinfo), (tp, topt, _) in _adamw_runs(
            "bfloat16", (0.002, 0.0015, 0.002), warmup=5):
        for path, t in ttree.flatten(tp):
            want = np.asarray(_at(rp, path))
            assert t.dtype == (torch.float32 if want.dtype == np.float32
                               else torch.bfloat16), path
            np.testing.assert_array_equal(_bits(ckpt_np(t)), _bits(want))
            np.testing.assert_array_equal(_at(topt["m"], path).numpy(),
                                          np.asarray(_at(ropt["m"], path)))


def test_adamw_apply_matches_reference_bf16_within_an_ulp():
    """Clipped steps into the cosine: an ulp of the global norm or of cos
    may move a float32 value across a bf16 rounding midpoint, so a bf16
    parameter may differ by one bf16 ulp of its value (rtol 2**-7, the
    widest one ulp is relative to a value; atol for values that cancel
    to near zero), and rarely does."""
    for (rp, _, _), (tp, _, _) in _adamw_runs(
            "bfloat16", (0.002, 0.1, 0.002, 0.1), warmup=2):
        for path, t in ttree.flatten(tp):
            if t.dtype != torch.bfloat16:
                continue
            got = t.float().numpy()
            want = np.asarray(_at(rp, path)).astype(np.float32)
            np.testing.assert_allclose(
                got, want, rtol=2.0 ** -7,
                atol=1e-6 * float(np.abs(want).max()), err_msg=str(path))
            assert (got != want).sum() <= max(1, want.size // 1000), path


def ckpt_np(t):
    """A port tensor's bits as numpy (bf16 as int16)."""
    return (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.detach().numpy())


# ----------------------------------------------------- loss and grads


def _reference_grads(rcfg, tree, batch):
    def loss(p):
        return rmodel.train_loss(p, rcfg, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    return jax.value_and_grad(loss, has_aux=True)(_jax_tree(tree))


@pytest.mark.parametrize("arch", tregistry.list_archs())
def test_train_loss_and_grads_match_reference(arch):
    rcfg, tcfg = _cfgs(arch)
    tree = convert.numpy_params(tcfg, 0)
    batch = _batch(tcfg)
    (rl, rm), rg = _reference_grads(rcfg, tree, batch)
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    tl, tm, tg = tsteps.loss_and_grads(tcfg, tp, _torch_batch(batch))
    np.testing.assert_allclose(float(tl), float(rl), rtol=LOSS_RTOL)
    for key in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(tm[key]), float(rm[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    atol = GRAD_ATOL.get(tcfg.family, 1e-6)
    for path, g in ttree.flatten(tg):
        want = np.asarray(_at(rg, path))
        assert tuple(g.shape) == want.shape, path
        np.testing.assert_allclose(
            g.numpy(), want, rtol=GRAD_RTOL,
            atol=atol * float(np.abs(want).max()), err_msg="/".join(path))


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def _grads_with_remat(tcfg, tree, batch, remat):
    cfg = dataclasses.replace(tcfg, remat=remat)
    params = convert.params_from_numpy(tree, cfg, "cpu")
    flat = ttree.flatten(params)
    for _, p in flat:
        p.requires_grad_(True)
    loss, _ = tmodel.train_loss(params, cfg, _torch_batch(batch))
    with _CountProducts() as backward:
        grads = torch.autograd.grad(loss, [p for _, p in flat],
                                    allow_unused=True)
    return loss, grads, backward.counts


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "mamba2-780m", "hymba-1.5b"])
def test_remat_policies_give_equal_losses_and_grads(arch):
    """``none``, ``dots`` and ``full`` agree exactly; in the backward,
    ``full`` recomputes every product, ``dots`` only the batched ones
    (``bmm``: attention, experts, the SSD scan) and no 2-D ``mm``."""
    _, tcfg = _cfgs(arch)
    tree = convert.numpy_params(tcfg, 0)
    batch = _batch(tcfg)
    with _CountProducts() as fwd:
        tmodel.train_loss(convert.params_from_numpy(tree, tcfg, "cpu"),
                          tcfg, _torch_batch(batch))
    runs = {r: _grads_with_remat(tcfg, tree, batch, r)
            for r in ("none", "dots", "full")}
    loss0, grads0, back0 = runs["none"]
    for remat in ("dots", "full"):
        loss, grads, _ = runs[remat]
        assert torch.equal(loss, loss0), remat
        for a, b in zip(grads, grads0):
            assert (a is None and b is None) or torch.equal(a, b), remat
    none, dots, full = (runs[r][2] for r in ("none", "dots", "full"))
    assert dots["mm"] == none["mm"]           # every 2-D product kept
    assert full["mm"] > none["mm"]
    if fwd.counts["bmm"]:
        assert none["bmm"] < dots["bmm"] <= none["bmm"] + fwd.counts["bmm"]
        assert full["bmm"] == dots["bmm"]


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_step_flops_counts_the_step_s_products(remat):
    """``train_smoke.step_flops``: its count as the port computes it
    equals torch's FlopCounterMode over one step of a dense smoke config,
    KV chunks padded (S 1100 > one 1024 chunk); its attention as the
    function needs it (the full-width step's bound in chip_smoke.py)
    counts each causal (query, key) pair of the mask once in each of the
    products' runs (forward, backward, recompute under dots)."""
    from torch.utils.flop_counter import FlopCounterMode
    _, tcfg = _cfgs("tinyllama-1.1b", remat=remat)
    params = convert.params_from_numpy(convert.numpy_params(tcfg, 0), tcfg,
                                       "cpu")
    batch = _torch_batch(_batch(tcfg, batch=1, seq_len=1100))
    with FlopCounterMode(display=False) as counter:
        tsteps.loss_and_grads(tcfg, params, batch)
    counts = {str(k): v for k, v in
              counter.get_flop_counts()["Global"].items()}
    want = train_smoke.step_flops(tcfg, 1, 1100)
    assert counts == {"aten.mm": want["projections"],
                      "aten.bmm": want["attention_computed"]}
    causal_pairs = int(np.tril(np.ones((1100, 1100), bool)).sum())
    runs = 4 if remat == "dots" else 3
    assert want["attention"] == (runs * 4 * tcfg.n_q_eff * tcfg.head_dim
                                 * tcfg.n_layers * causal_pairs)
    assert want["attention"] < want["attention_computed"]


def test_layers_are_unbound_once_per_leaf():
    """forward_hidden takes each stacked leaf apart with one unbind, and
    its backward writes each leaf's gradient with one stack (a ``v[i]``
    per layer would back into a zero (L, ...) tensor per layer)."""
    _, tcfg = _cfgs("tinyllama-1.1b", n_layers=3)
    params = convert.params_from_numpy(convert.numpy_params(tcfg, 0), tcfg,
                                       "cpu")
    leaves = ttree.leaves(params["layers"])
    for p in leaves:
        p.requires_grad_(True)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    x = torch.zeros(1, 4, tcfg.d_model)
    with Ops() as fwd:
        hidden, _ = tmodel.forward_hidden(params, tcfg, x, torch.arange(4))
    with Ops() as bwd:
        torch.autograd.grad(hidden.sum(), leaves)
    assert fwd.seen.count("unbind") == len(leaves)
    assert bwd.seen.count("stack") == len(leaves)


def test_make_train_step_matches_reference():
    """One step of ``make_train_step`` on a MoE smoke config (LW+), with
    the metrics the reference returns."""
    rcfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    tree = convert.numpy_params(tcfg, 0)
    batch = _batch(tcfg, batch=4)
    rp = _jax_tree(tree)
    rstate = {"params": rp, "opt": radamw.init(rp)}
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=4)
    rfn = jax.jit(rsteps.make_train_step(rcfg, radamw.AdamWConfig(**kw),
                                         lambda name, x: x))
    _, rmet = rfn(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    tfn = tsteps.make_train_step(tcfg, tadamw.AdamWConfig(**kw))
    tstate, tmet = tfn({"params": tp, "opt": tadamw.init(tp)},
                       _torch_batch(batch))
    assert sorted(tmet) == sorted(rmet)
    for key in rmet:
        np.testing.assert_allclose(float(tmet[key]), float(rmet[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert int(tstate["opt"]["step"]) == 1


def test_prefill_and_serve_steps_match_reference():
    """``make_prefill_step`` and ``make_serve_step`` (under no_grad, so
    params that require grad serve) against the reference's, and
    ``cache_struct`` against its cache's shapes."""
    rcfg, tcfg = _cfgs("hymba-1.5b")
    tree = convert.numpy_params(tcfg, 0)
    toks = _batch(tcfg, batch=2, seq_len=12)["tokens"]
    rpre = rsteps.make_prefill_step(rcfg, 16, lambda name, x: x)
    rdec = rsteps.make_serve_step(rcfg, lambda name, x: x)
    rp = _jax_tree(tree)
    rl, rc = rpre(rp, {"tokens": jnp.asarray(toks)})
    rl2, _ = rdec(rp, jnp.asarray(toks[:, :1]), rc)
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    for p in ttree.leaves(tp):
        p.requires_grad_(True)
    tl, tc = tsteps.make_prefill_step(tcfg, 16)(
        tp, {"tokens": torch.from_numpy(toks)})
    tl2, _ = tsteps.make_serve_step(tcfg)(tp, torch.from_numpy(toks[:, :1]),
                                          tc)
    for got, want in ((tl, rl), (tl2, rl2)):
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    shape = dataclasses.replace(get_shape("decode_32k"), seq_len=16,
                                global_batch=2)
    want = rsteps.cache_struct(rcfg, shape)
    got = tsteps.cache_struct(tcfg, shape)
    for key in ("kv", "ssm"):
        for name, t in got[key].items():
            if isinstance(t, torch.Tensor):
                assert t.device.type == "meta"
                assert tuple(t.shape) == want[key][name].shape, name


@pytest.mark.parametrize("accum", [1, 2])
def test_accum_train_steps_match_reference(accum):
    """Six steps of ``make_accum_train_step`` against the reference's
    jitted step, from the same weights and batches."""
    rcfg, tcfg = _cfgs("tinyllama-1.1b")
    tree = convert.numpy_params(tcfg, 0)
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=6)
    rfn = jax.jit(rtrain.make_accum_train_step(
        rcfg, radamw.AdamWConfig(**kw), lambda name, x: x, accum))
    tfn = ttrain.make_accum_train_step(tcfg, tadamw.AdamWConfig(**kw), accum)
    rp = _jax_tree(tree)
    rstate = {"params": rp, "opt": radamw.init(rp)}
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    tstate = {"params": tp, "opt": tadamw.init(tp)}
    rl, tl = [], []
    for step in range(6):
        b = _batch(tcfg, step, batch=4)
        if accum > 1:
            b = {k: v.reshape(accum, -1, *v.shape[1:]) for k, v in b.items()}
        rstate, rmet = rfn(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tfn(tstate, _torch_batch(b))
        rl.append(float(rmet["loss"]))
        tl.append(float(tmet["loss"]))
    np.testing.assert_allclose(tl, rl, rtol=1e-4)


# ------------------------------------------------------- fault runtime


def test_straggler_events_match_reference():
    rng = np.random.default_rng(5)
    durs = list(rng.uniform(0.9, 1.1, 80))
    for i in (15, 33, 34, 60, 79):
        durs[i] = 3.0 + i / 100
    durs[40:44] = [1.0] * 4
    for kw in (dict(), dict(window=12, k=3.0, min_samples=4)):
        r, t = rstraggler.StragglerMonitor(**kw), \
            tstraggler.StragglerMonitor(**kw)
        seen = []
        t.on_straggler = seen.append
        for step, d in enumerate(durs):
            r.observe(step, d)
            t.observe(step, d)
        assert [dataclasses.astuple(e) for e in t.events] == \
            [dataclasses.astuple(e) for e in r.events]
        assert t.events and seen == t.events
    t = tstraggler.StragglerMonitor()
    t.start_step()
    assert t.end_step(0) is None and len(t.window) == 1


def test_failure_injector_matches_reference(tmp_path):
    for pkg in (rfault, tfault):
        marker = str(tmp_path / f"{pkg.__name__}.marker")
        inj = pkg.FailureInjector(3, marker_path=marker)
        inj.check(2)
        with pytest.raises(pkg.SimulatedFailure, match="step 3"):
            inj.check(3)
        with open(marker) as fh:
            assert fh.read() == "3"
        inj.check(3)                       # already failed once
        again = pkg.FailureInjector(4)
        with pytest.raises(pkg.SimulatedFailure):
            again.check(4)
        with pytest.raises(pkg.SimulatedFailure):
            again.check(4)                 # no marker: fails every time
        pkg.FailureInjector(None).check(0)
    assert issubclass(tfault.SimulatedFailure, RuntimeError)


# --------------------------------------------------- driver and drill


def _drill_args(d, *extra):
    return ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "18",
            "--batch", "4", "--seq-len", "64", "--ckpt-every", "6",
            "--log-every", "100", "--device", "cpu", "--ckpt-dir", d,
            *extra]


def test_kill_resume_bitwise_identical():
    """The reference's drill, on the port alone: a run killed at step 12
    and resumed gives the uninterrupted run's losses bit for bit."""
    d1 = tempfile.mkdtemp()
    try:
        ref = ttrain.main(_drill_args(d1))
    finally:
        shutil.rmtree(d1)
    d2 = tempfile.mkdtemp()
    try:
        with pytest.raises(tfault.SimulatedFailure):
            ttrain.main(_drill_args(d2, "--fail-at", "12"))
        assert tckpt.latest_step(d2) == 12
        resumed = ttrain.main(_drill_args(d2))
    finally:
        shutil.rmtree(d2)
    assert resumed["losses"] == ref["losses"][12:]
    assert resumed["final_step"] == 18 and len(ref["losses"]) == 18


def test_drill_helper_on_cpu(tmp_path):
    """``train_smoke.drill`` (which ``chip_smoke.py`` runs on the card at
    full width) on the smoke config, with remat, on the CPU."""
    cfg = dataclasses.replace(tregistry.get_config("tinyllama-1.1b", True),
                              remat="dots")
    out = train_smoke.drill(cfg, "cpu", str(tmp_path))
    assert out["resumed"] == out["uninterrupted"][12:]
    assert os.listdir(tmp_path) == []


def test_train_main_log_and_json(capsys):
    out = ttrain.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--steps",
                       "3", "--batch", "4", "--seq-len", "16", "--accum",
                       "2", "--log-every", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[:2] for ln in lines[:-1]] == [["step", "0"],
                                                      ["step", "2"]]
    assert json.loads(lines[-1]) == {k: out[k] for k in (
        "first_loss", "last_loss", "straggler_events", "final_step")}
    assert len(out["losses"]) == len(out["step_s"]) == 3
    assert all(np.isfinite(out["losses"]))


def test_model_parallel_and_cuda_without_card_raise():
    """One process is a world of one rank: a (1, 2) mesh needs two."""
    with pytest.raises(RuntimeError, match="needs at least 2 ranks"):
        ttrain.main(["--smoke", "--steps", "1", "--device", "cpu",
                     "--model-parallel", "2"])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1"])


def test_train_cli_defaults_to_card():
    src = open(ttrain.__file__, encoding="utf-8").read()
    calls = [n for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
             == "add_argument" and n.args
             and getattr(n.args[0], "value", None) == "--device"]
    assert [kw.value.value for kw in calls[0].keywords
            if kw.arg == "default"] == ["cuda"]


# --------------------------------------------------------- checkpoints


def _bf16_state(arch="qwen2-moe-a2.7b"):
    """A bf16 smoke state after one step, in both packages (same bits)."""
    rcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    tp = convert.params_from_numpy(convert.numpy_params(tcfg, 0), tcfg,
                                   "cpu")
    tstate = {"params": tp, "opt": tadamw.init(tp)}
    step = ttrain.make_accum_train_step(
        tcfg, tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=2), 1)
    tstate, _ = step(tstate, _torch_batch(_batch(tcfg)))
    rstate = {"params": ttree.map_leaves(_to_jax, tstate["params"]),
              "opt": {"m": ttree.map_leaves(_to_jax, tstate["opt"]["m"]),
                      "v": ttree.map_leaves(_to_jax, tstate["opt"]["v"]),
                      "step": jnp.asarray(1, jnp.int32)}}
    return rcfg, tcfg, rstate, tstate


def _same_files(d_a, d_b, step):
    a = os.path.join(d_a, f"step_{step:08d}")
    b = os.path.join(d_b, f"step_{step:08d}")
    for d in (a, b):
        assert sorted(os.listdir(d)) == ["host_0.npz", "manifest.json"]
    with open(os.path.join(a, "manifest.json")) as fa, \
            open(os.path.join(b, "manifest.json")) as fb:
        ma, mb = json.load(fa), json.load(fb)
    assert ma == mb
    assert "bfloat16" in ma["dtypes"].values()
    assert ma["dtypes"]["opt/step"] == "int32"
    assert "params/layers/attn/wq" in ma["keys"]
    with np.load(os.path.join(a, "host_0.npz")) as za, \
            np.load(os.path.join(b, "host_0.npz")) as zb:
        assert sorted(za.files) == sorted(zb.files) == ma["keys"]
        for k in za.files:
            assert za[k].tobytes() == zb[k].tobytes(), k
            assert za[k].shape == zb[k].shape, k


def test_checkpoints_interoperate_with_reference(tmp_path):
    """The same bf16 state saved by each package: equal manifests and
    equal bytes; each package restores the other's with equal bytes,
    bf16 leaves and ``opt/step`` included."""
    rcfg, tcfg, rstate, tstate = _bf16_state()
    rdir, tdir = str(tmp_path / "r"), str(tmp_path / "t")
    rckpt.save(rdir, 7, rstate)
    tckpt.save(tdir, 7, tstate)
    _same_files(rdir, tdir, 7)
    assert tckpt.latest_step(rdir) == rckpt.latest_step(tdir) == 7

    got = tckpt.restore(rdir, tsteps.state_struct(tcfg))
    for path, want in ttree.flatten(tstate):
        t = _at(got, path)
        assert t.dtype == want.dtype and t.device.type == "cpu", path
        assert ckpt_np(t).tobytes() == ckpt_np(want).tobytes(), path
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 1

    target = jax.eval_shape(lambda: rstate)
    back = rckpt.restore(tdir, target)
    for path, want in jax.tree_util.tree_flatten_with_path(rstate)[0]:
        leaf = _at(back, [p.key for p in path])
        assert leaf.dtype == want.dtype, path
        assert np.asarray(leaf).tobytes() == np.asarray(want).tobytes()


def test_async_checkpointer_snapshots_before_the_next_step(tmp_path):
    """The snapshot is taken at ``save``: updating the state in place
    afterwards does not reach the file (the port's AdamW updates in
    place, where the reference's arrays are immutable)."""
    _, tcfg, _, tstate = _bf16_state("tinyllama-1.1b")
    before = ckpt_np(tstate["params"]["embed"]).copy()
    saver = tckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    saver.save(1, tstate)
    with torch.no_grad():
        tstate["params"]["embed"].add_(1.0)
    saver.wait()
    for step in (2, 3):
        saver.save(step, tstate)
    saver.wait()
    assert tckpt.all_steps(str(tmp_path)) == [2, 3]      # keep=2
    tckpt.save(str(tmp_path), 1, {"params": {"embed": torch.from_numpy(
        before).view(torch.bfloat16)}}, keep=5)
    got = tckpt.restore(str(tmp_path), {"params": {
        "embed": torch.empty(before.shape, dtype=torch.bfloat16,
                             device="meta")}}, step=1)
    assert ckpt_np(got["params"]["embed"]).tobytes() == before.tobytes()
    with pytest.raises(KeyError, match="missing key opt/m/embed"):
        tckpt.restore(str(tmp_path), tsteps.state_struct(tcfg), step=1)


def test_state_struct_matches_reference_and_allocates_nothing():
    for arch in ("qwen2-moe-a2.7b", "hymba-1.5b"):
        rcfg = rregistry.get_config(arch, smoke=True)
        tcfg = tregistry.get_config(arch, smoke=True)
        rs = rsteps.state_struct(rcfg)
        ts = tsteps.state_struct(tcfg)
        rflat = {"/".join(str(p.key) for p in path): leaf for path, leaf
                 in jax.tree_util.tree_flatten_with_path(rs)[0]}
        tflat = {"/".join(p): t for p, t in ttree.flatten(ts)}
        assert list(tflat) == list(rflat)
        for k, t in tflat.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == rflat[k].shape, k
            assert str(t.dtype).split(".")[-1] == str(rflat[k].dtype), k
    full = tsteps.state_struct(tregistry.get_config("tinyllama-1.1b"))
    nbytes = sum(t.numel() * t.element_size() for t in ttree.leaves(full))
    assert 10.5e9 < nbytes < 11.5e9     # 2.2 GB params + 8.8 GB moments
    shape = get_shape("train_4k")
    for arch, key in (("tinyllama-1.1b", "tokens"),
                      ("musicgen-medium", "input_embeds")):
        rb = rsteps.batch_struct(rregistry.get_config(arch), shape)
        tb = tsteps.batch_struct(tregistry.get_config(arch), shape)
        assert list(tb) == list(rb) == [key, "labels"]
        for k, t in tb.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == rb[k].shape
            assert str(t.dtype).split(".")[-1] == str(rb[k].dtype)


def test_opt_state_converts_both_ways():
    rcfg, tcfg = _cfgs("mamba2-780m")
    rp = _jax_tree(convert.numpy_params(tcfg, 0))
    ropt = radamw.init(rp)
    ropt = jax.tree.map(lambda a: a + 0.5, ropt)
    ropt["step"] = jnp.asarray(9, jnp.int32)
    np_opt = jax.tree.map(np.asarray, ropt)
    topt = convert.opt_from_numpy(np_opt, tcfg, "cpu")
    assert topt["step"].dtype == torch.int32 and int(topt["step"]) == 9
    back = convert.opt_to_numpy(topt)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 9
    for key in ("m", "v"):
        for path, leaf in ttree.flatten(back[key]):
            assert leaf.dtype == np.float32
            np.testing.assert_array_equal(leaf, _at(np_opt[key], path))
    bad = jax.tree.map(lambda a: a, np_opt)
    bad["m"]["embed"] = bad["m"]["embed"][:, :3]
    with pytest.raises(ValueError, match="embed"):
        convert.opt_from_numpy(bad, tcfg, "cpu")


# ------------------------------------------------ kernels under autograd


def test_kernels_refuse_autograd_like_the_reference():
    """``jax.grad`` through the reference's SW+ dispatch raises (no
    transpose rule for ``pallas_call``); the port's kernel wrappers raise
    too when autograd records, and run without it."""
    rcfg, tcfg = _cfgs("qwen2-moe-a2.7b", moe_dispatch="sw_plus")
    tree = convert.numpy_params(tcfg, 0)
    lp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["moe"])
    x = np.random.default_rng(0).standard_normal(
        (16, tcfg.d_model)).astype(np.float32)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda xx: rmoe.dispatch_sw_plus(lp, xx, rcfg)[0].sum())(
            jnp.asarray(x))
    tp = convert.params_from_numpy(tree, tcfg, "cpu")
    tlp = tmodel.layer_params(tp, 0)["moe"]
    xt = torch.from_numpy(x).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        tmoe.dispatch_sw_plus(tlp, xt, tcfg)
    with torch.no_grad():
        y, _ = tmoe.dispatch_sw_plus(tlp, xt, tcfg)
    assert y.shape == (16, tcfg.d_model)

    g = torch.zeros(128, 8, requires_grad=True)
    w = torch.zeros(2, 8, 8)
    calls = {
        "moe_gmm": lambda: tops.moe_gmm(
            g, w, torch.zeros(1, dtype=torch.int32)),
        "coalesced_gather": lambda: tops.coalesced_gather(
            g, torch.arange(4), torch.arange(4), 128),
        "flash_attention": lambda: tops.flash_attention(
            g[None, :, :], g[None, :, :], g[None, :, :]),
        "ssd_scan": lambda: tops.ssd_scan(
            g[None], torch.zeros(1, 128), torch.zeros(1, 128, 4),
            torch.zeros(1, 128, 4)),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call()
        with torch.no_grad():
            call()


def test_serve_with_params_that_require_grad_matches_golden_file():
    """Weights that require grad (as after training) still serve: the
    serve runs under torch.no_grad(), and its tokens and logits equal the
    reference's smoke serve in the golden file."""
    with open(GOLDEN_FILE, encoding="utf-8") as fh:
        blob = json.load(fh)
    g = blob["serve"]
    tcfg = dataclasses.replace(tregistry.get_config(g["arch"], g["smoke"]),
                               dtype=g["dtype"],
                               moe_dispatch=g["moe_dispatch"])
    tp = convert.params_from_numpy(convert.numpy_params(tcfg, g["seed"]),
                                   tcfg, "cpu")
    for p in ttree.leaves(tp):
        p.requires_grad_(True)
    reqs = tserve.make_requests(tcfg, g["requests"], g["max_new"],
                                g["seed"])
    server = tserve.BatchedServer(tcfg, tp, g["slots"], g["max_len"],
                                  device="cpu")
    log = []
    decode = server._decode

    def dec(p, t, c):
        logits, cache = decode(p, t, c)
        log.append(logits.numpy())
        return logits, cache

    server._decode = dec
    stats = server.run(reqs)
    assert [r.generated for r in reqs] == blob["tokens"]
    assert stats["decode_steps"] == blob["decode_steps"]
    want = [s["logits"] for s in blob["steps"] if s["kind"] == "decode"]
    assert len(log) == len(want)
    for got, w in zip(log, want):
        np.testing.assert_allclose(got[:, :tcfg.vocab_size], np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------- on the card


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", train_smoke.SMOKE_ARCHS)
def test_smoke_steps_on_card_match_cpu(card, arch):
    out = train_smoke.check_smoke_steps(arch, card)
    assert len(out["device"]["loss"]) == 3


@pytest.mark.gpu
def test_kill_resume_drill_on_card_at_full_width(card):
    """Checkpoints of 1.6 GB go under the checkout's build/, as in
    chip_smoke.py (the temporary directory may be small)."""
    cfg = dataclasses.replace(tregistry.get_config("tinyllama-1.1b"),
                              n_layers=2)
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        out = train_smoke.drill(cfg, card, work)
    assert out["resumed"] == out["uninterrupted"][12:]


@pytest.mark.gpu
def test_full_width_training_on_card(card):
    from repro_torch import kernels
    kernels.reset_launch_counts()
    out = train_smoke.full_width_run(card)
    assert len(out["losses"]) == 6 and out["peak_bytes"] < 80e9
    assert all(kernels.launch_count(k) == 0 for k in kernels.KERNELS)


@pytest.mark.gpu
def test_autograd_guard_on_card(card):
    train_smoke.check_autograd_guard(card)
