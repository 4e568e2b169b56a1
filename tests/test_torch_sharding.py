"""The port's distribution layer in one process, held against the
reference: the sharding rules, int8 compression, the elastic mesh shapes,
and every distributed entry point on a world of one rank (gloo), where
the step must be the plain step's operations, bit for bit.

Tolerances: spec rules, ``quantize``/``dequantize``, the world-of-one
steps and checkpoints are exact. The expert-parallel layer against the
dense oracle: rtol 1e-4, atol 1e-5 (the reference's own test,
``tests/test_granularity.py``); the sequence-sharded decode against
softmax attention: rtol 1e-5, atol 1e-5 (the same test's tolerance).
Multi-rank checks are in ``tests/test_torch_dist.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch import sharding as tsharding
from repro_torch import tree as ttree
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import registry as tregistry
from repro_torch.core import granularity as tgran
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import compression as tcomp
from repro_torch.runtime import elastic as telastic

try:
    import jax
    import jax.numpy as jnp

    from repro import sharding as rsharding
    from repro.configs import registry as rregistry
    from repro.models import model as rmodel
    from repro.optim import compression as rcomp
    from repro.runtime import elastic as relastic
except ImportError:     # a machine with a card and no jax
    jax = None


@pytest.fixture(autouse=True)
def _reference():
    if jax is None:
        pytest.skip("needs jax, the reference package's framework")


def _spec_dict(tree, is_port):
    """{path: spec as a tuple} of a spec tree of either package."""
    if is_port:
        return {path: tuple(s) for path, s in ttree.flatten(tree)}
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in flat}


class _Mesh2x2:
    """The names and shape of a (2, 2) mesh: all the rules read."""
    mesh_dim_names = ("data", "model")
    shape = (2, 2)


# ------------------------------------------------------------ spec rules


@pytest.mark.parametrize("layout", ["tp", "fsdp", "swep"])
@pytest.mark.parametrize("arch", tregistry.list_archs())
def test_param_specs_match_reference(arch, layout):
    rcfg = rregistry.get_config(arch)
    ref = rsharding.param_specs(jax.eval_shape(
        lambda: rmodel.init_params(jax.random.PRNGKey(0), rcfg)), layout)
    got = tsharding.param_specs(convert.param_struct(
        tregistry.get_config(arch)), layout)
    assert _spec_dict(got, True) == _spec_dict(ref, False)
    assert all(isinstance(s, tsharding.PartitionSpec)
               for s in ttree.leaves(got))


def test_cache_specs_match_reference():
    rcfg = rregistry.get_config("hymba-1.5b", smoke=True)
    ref = rsharding.cache_specs(jax.eval_shape(
        lambda: rmodel.init_decode_cache(rcfg, 4, 64)), "data")
    tcfg = tregistry.get_config("hymba-1.5b", smoke=True)
    got = tsharding.cache_specs(tsteps.cache_struct(
        tcfg, ShapeConfig(name="d", seq_len=64, global_batch=4,
                          kind="decode")), "data")
    assert _spec_dict(got, True) == _spec_dict(ref, False)
    assert got["kv"]["k"] == (None, "data", None, "model", None)


@pytest.mark.parametrize("dp", [("data",), ("pod", "data"), None])
def test_batch_specs_match_reference(dp):
    tcfg = tregistry.get_config("tinyllama-1.1b", smoke=True)
    shape = ShapeConfig(name="t", seq_len=16, global_batch=8, kind="train")
    got = tsharding.batch_specs(tsteps.batch_struct(tcfg, shape), dp)
    ref = rsharding.batch_specs(
        {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32),
         "labels": jax.ShapeDtypeStruct((8, 16), jnp.int32)}, dp)
    assert _spec_dict(got, True) == _spec_dict(ref, False)


@pytest.mark.parametrize("batch", [8, 3, 6])
def test_data_axes_match_reference(batch):
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    assert tsharding.data_axes(_Mesh2x2(), batch) == \
        rsharding.data_axes(mesh, batch)


def test_partition_spec_canonical_like_jax():
    for entries in [(("data",), None), ((), "model"), (("data", "model"),),
                    ()]:
        assert tuple(tsharding.PartitionSpec(*entries)) == \
            tuple(jax.sharding.PartitionSpec(*entries))


def test_to_placements_one_per_mesh_dim():
    P = tsharding.PartitionSpec
    mesh = _Mesh2x2()
    assert tsharding.to_placements(mesh, P("model", "data")) == \
        (Shard(1), Shard(0))
    assert tsharding.to_placements(mesh, P(None, ("data", "model"))) == \
        (Shard(1), Shard(1))
    assert tsharding.to_placements(mesh, P()) == (Replicate(), Replicate())
    tree = tsharding.to_placements(mesh, {"a": {"b": P("data")}})
    assert tree == {"a": {"b": (Shard(0), Replicate())}}
    with pytest.raises(ValueError, match="order"):
        tsharding.to_placements(mesh, P(("model", "data")))
    with pytest.raises(ValueError, match="pod"):
        tsharding.to_placements(mesh, P("pod"))


def test_fsdp_cache_over_every_axis_refused_like_reference():
    """The reference's fsdp prefill/decode arms refuse a batch that
    divides every device: the cache names "model" twice (its
    ``DuplicateSpecError``); the port's placements refuse it too."""
    tcfg = tregistry.get_config("tinyllama-1.1b", smoke=True)
    cache = tsteps.cache_struct(tcfg, ShapeConfig(
        name="d", seq_len=16, global_batch=4, kind="decode"))
    with pytest.raises(ValueError, match="'model' twice"):
        tsharding.to_placements(_Mesh2x2(), tsharding.cache_specs(
            cache, ("data", "model")))
    rcfg = rregistry.get_config("tinyllama-1.1b", smoke=True)
    rcache = jax.eval_shape(lambda: rmodel.init_decode_cache(rcfg, 4, 16))
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    with pytest.raises(Exception, match="at most one positional"):
        rsharding.to_named(mesh, rsharding.cache_specs(
            rcache, ("data", "model")))


# ------------------------------------------------------- compression


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_reference_bit_for_bit(dtype):
    g = (np.random.default_rng(0).standard_normal((256, 33)) * 3e-3
         ).astype(np.float32)
    g[0, 0] = 0.5 * np.abs(g).max()         # a tie rounds half to even
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    rg = jnp.asarray(g).astype(getattr(jnp, dtype))
    tq, ts = tcomp.quantize(tg)
    rq, rs = rcomp.quantize(rg)
    assert np.array_equal(tq.numpy(), np.asarray(rq))
    assert np.array_equal(ts.numpy(), np.asarray(rs))
    back = tcomp.dequantize(tq, ts, tg.dtype)
    rback = rcomp.dequantize(rq, rs, rg.dtype)
    assert np.array_equal(_bits(back.view(torch.int16).numpy()
                                if dtype == "bfloat16" else back.numpy()),
                          _bits(np.asarray(rback)))


def test_error_feedback_matches_reference():
    rng = np.random.default_rng(1)
    g, q = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2))
    tr = tcomp.ErrorFeedback.init({"g": torch.from_numpy(g)})
    rr = rcomp.ErrorFeedback.init({"g": jnp.asarray(g)})
    tcomp_, tupd = tcomp.ErrorFeedback.apply({"g": torch.from_numpy(g)}, tr)
    rcomp_, rupd = rcomp.ErrorFeedback.apply({"g": jnp.asarray(g)}, rr)
    assert np.array_equal(tcomp_["g"].numpy(), np.asarray(rcomp_["g"]))
    assert np.array_equal(tupd({"g": torch.from_numpy(q)})["g"].numpy(),
                          np.asarray(rupd({"g": jnp.asarray(q)})["g"]))


# ------------------------------------------------------------ elastic


@pytest.mark.parametrize("n,mp", [(7, 2), (4, 1), (16, 4), (3, 4)])
def test_viable_mesh_shapes_match_reference(n, mp):
    assert telastic.viable_mesh_shapes(n, mp) == \
        relastic.viable_mesh_shapes(n, mp)
    if (n, mp) == (7, 2):
        assert telastic.viable_mesh_shapes(7, 2)[0] == (3, 2)


# ----------------------------------------------------- a world of one


@pytest.fixture
def mesh1():
    return tmesh.make_host_mesh(1, "cpu")


def test_host_mesh_of_one_and_too_few_ranks(mesh1):
    assert tuple(mesh1.shape) == (1, 1)
    assert mesh1.mesh_dim_names == ("data", "model")
    with pytest.raises(RuntimeError, match="needs at least 2 ranks"):
        tmesh.make_host_mesh(2, "cpu")
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b"])
def test_build_step_on_one_rank_is_the_plain_step(mesh1, arch, accum):
    """On a (1, 1) mesh the mesh step runs the plain step's operations:
    losses, grad norms and the state bit for bit, and the state's local
    tensors are the full tensors it was made from (no copy)."""
    args = ttrain.parse_args(["--arch", arch, "--smoke", "--steps", "3",
                              "--batch", "4", "--seq-len", "16", "--accum",
                              str(accum), "--device", "cpu"])
    cfg = dataclasses.replace(tregistry.get_config(arch, smoke=True),
                              remat="none")
    get_batch = ttrain.batch_fn(args, cfg, "cpu")
    plain = ttrain.make_accum_train_step(cfg, ttrain.opt_config(args), accum)
    state = ttrain.init_state(cfg, 0, "cpu")
    fn, _, in_pl, _ = tsteps.build_step(
        cfg, ShapeConfig(name="t", seq_len=16, global_batch=4, kind="train"),
        mesh1, ttrain.opt_config(args), "tp", accum=accum)
    fresh = ttrain.init_state(cfg, 0, "cpu")
    placed = tsharding.distribute_tree(fresh, mesh1, in_pl[0])
    assert all(a.to_local().data_ptr() == b.data_ptr() for a, b in zip(
        ttree.leaves(placed), ttree.leaves(fresh)))
    for i in range(3):
        state, m1 = plain(state, get_batch(i))
        placed, m2 = fn(placed, get_batch(i))
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(m1[k], m2[k]), (i, k)
    for a, b in zip(ttree.leaves(state), ttree.leaves(placed)):
        assert torch.equal(a, b.to_local())


@pytest.mark.parametrize("layout", ["tp", "fsdp", "swep"])
def test_make_sharder_specs_are_the_reference_table(layout):
    """make_sharder's specs are the reference's (read from its closure)."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    ref = rsharding.make_sharder(mesh, ("data",), layout)
    cells = dict(zip(ref.__code__.co_freevars,
                     (c.cell_contents for c in ref.__closure__)))
    got = tsharding.make_sharder(None, ("data",), layout).specs
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in cells["specs"].items()}


def test_sharder_checks_local_blocks_on_one_rank(mesh1):
    """A named activation passes back unchanged when its shape is its
    spec's local block (the bound rows, vocab, d_model and experts, the
    capacity given), and raises otherwise; the default does no check."""
    cfg = tregistry.get_config("qwen2-moe-a2.7b", smoke=True)
    params = tsharding.distribute_tree(
        convert.params_from_numpy(convert.numpy_params(cfg, 0), cfg, "cpu"),
        mesh1, tsharding.to_placements(mesh1, tsharding.param_specs(
            convert.param_struct(cfg))))
    sh = tsharding.make_sharder(mesh1, ("data",), "tp").bind(params, rows=4)
    v, d, e = cfg.vocab_padded, cfg.d_model, cfg.moe_experts_eff
    for name, shape, sizes in (("hidden", (4, 3, d), {}),
                               ("logits", (4, 1, v), {}),
                               ("expert_in", (e, 8, d), {"capacity": 8})):
        x = torch.zeros(shape)
        assert sh(name, x, **sizes) is x
        bad = torch.zeros((shape[0] + 1,) + shape[1:])
        with pytest.raises(ValueError, match=name):
            sh(name, bad, **sizes)
    assert sh.checked == {"hidden": 1, "logits": 1, "expert_in": 1}
    assert tsharding.NO_SHARDER("logits", bad) is bad


def test_collectives_on_one_rank_return_their_input(mesh1):
    """Over axes of one rank Megatron's operators, FSDP's gather and
    scatter and psum return their input itself and issue nothing."""
    tmesh.reset_counts()
    x = torch.ones(4, 6, requires_grad=True)
    for fn in (lambda t: tmesh.copy(t, mesh1, "model"),
               lambda t: tmesh.reduce(t, mesh1, "model"),
               lambda t: tmesh.psum(t, mesh1, ("data", "model")),
               lambda t: tmesh.gather(t, mesh1, ("data", "model"), 1, 6),
               lambda t: tmesh.scatter(t, mesh1, "data", 0)):
        assert fn(x) is x
    assert tmesh.collective_counts() == {}


def test_build_step_structs_no_allocation(mesh1):
    cfg = tregistry.get_config("tinyllama-1.1b", smoke=True)
    for kind in ("train", "prefill", "decode"):
        fn, args, in_pl, out_pl = tsteps.build_step(
            cfg, ShapeConfig(name="s", seq_len=64, global_batch=8,
                             kind=kind), mesh1)
        flat = []
        for a in args:
            flat += ttree.leaves(a) if isinstance(a, dict) else [a]
        assert all(t.device.type == "meta" for t in flat
                   if isinstance(t, torch.Tensor)), kind
        assert fn is not None and len(in_pl) == len(args)


def test_prefill_and_decode_arms_on_one_rank(mesh1):
    cfg = dataclasses.replace(tregistry.get_config("tinyllama-1.1b",
                                                   smoke=True),
                              dtype="float32")
    params = convert.params_from_numpy(convert.numpy_params(cfg, 3), cfg,
                                       "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    shape = ShapeConfig(name="p", seq_len=16, global_batch=2,
                        kind="prefill")
    pre, _, pin, pout = tsteps.build_step(cfg, shape, mesh1)
    dec, _, _, _ = tsteps.build_step(
        cfg, dataclasses.replace(shape, kind="decode"), mesh1)
    placed = tsharding.distribute_tree(params, mesh1, pin[0])
    logits, cache = pre(placed, {"tokens": toks})
    want, wcache = tsteps.make_prefill_step(cfg, 16)(params,
                                                     {"tokens": toks})
    assert torch.equal(tsharding.full_tensor(logits), want)
    nxt = toks[:, :1]
    logits, cache = dec(placed, nxt, cache)
    want, wcache = tsteps.make_serve_step(cfg)(params, nxt, wcache)
    assert torch.equal(tsharding.full_tensor(logits), want)
    assert torch.equal(tsharding.full_tensor(cache["kv"]["k"]),
                       wcache["kv"]["k"])
    assert cache["kv"]["index"] == wcache["kv"]["index"] == 9


def _moe_cfg(**kw):
    base = dict(name="g-moe", family="moe", d_model=64, n_heads=4,
                n_kv_heads=4, head_dim=16, d_ff=0, vocab_size=128,
                moe_experts=8, moe_shared=0, moe_top_k=2, moe_d_ff=32,
                moe_capacity_factor=8.0, dtype="float32", tp_divisor=2)
    base.update(kw)
    return TModelConfig(**base).validate()


def test_sw_plus_ep_on_one_rank_matches_oracle_and_sw_plus(mesh1):
    cfg = _moe_cfg()
    init = convert.NumpyInit(0)
    params = {k: torch.from_numpy(v) for k, v in
              tmoe.moe_init(init, cfg, torch.float32).items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, 64)).astype(np.float32))
    tgran.set_mesh(mesh1, ("data",))
    try:
        y, aux = tgran.sw_plus_ep_layer(params, x, cfg, block=8)
    finally:
        tgran.set_mesh(None)
    flat = x.reshape(-1, 64)
    for fn in (tmoe.dispatch_dense_oracle, tmoe.dispatch_sw_plus):
        want, waux = fn(params, flat, cfg)
        np.testing.assert_allclose(y.reshape(-1, 64).numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5)
        assert torch.equal(aux, waux)


def test_seq_sharded_decode_on_one_rank(mesh1):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 3, 16), (2, 32, 3, 16), (2, 32, 3, 16)))
    positions = torch.arange(32, dtype=torch.int32)
    positions[20:] = -1
    out = tgran.seq_sharded_decode_attention(q, k, v, positions, 19,
                                             mesh=mesh1)
    s = torch.einsum("bhd,bkhd->bhk", q / 4.0, k)
    s = s.masked_fill(~(positions >= 0)[None, None, :], -2.0e38)
    want = torch.einsum("bhk,bkhd->bhd", torch.softmax(s, -1), v)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_compressed_psum_on_one_rank_is_dequantize_quantize(mesh1):
    rng = np.random.default_rng(2)
    grads = {"a": torch.from_numpy(rng.standard_normal((64, 8)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(
            (16,)).astype(np.float32)).to(torch.bfloat16)}
    red = tcomp.compressed_psum_grads(grads, mesh1, "data")
    for k, g in grads.items():
        assert torch.equal(red[k], tcomp.dequantize(*tcomp.quantize(g),
                                                    g.dtype))


def test_checkpoint_of_dtensors_and_elastic_recover(mesh1, tmp_path):
    """A DTensor state writes the plain state's files; restore and
    ``elastic.recover`` give it back bit for bit as DTensors."""
    cfg = dataclasses.replace(tregistry.get_config("tinyllama-1.1b",
                                                   smoke=True),
                              dtype="bfloat16")
    state = ttrain.init_state(cfg, 0, "cpu")
    pl = tsharding.to_placements(mesh1, tsharding.state_specs(
        state["params"]))
    placed = tsharding.distribute_tree(state, mesh1, pl)
    tckpt.save(str(tmp_path / "a"), 3, state)
    tckpt.save(str(tmp_path / "b"), 3, placed)
    for name in ("manifest.json", "host_0.npz"):
        assert (tmp_path / "a" / "step_00000003" / name).read_bytes() == \
            (tmp_path / "b" / "step_00000003" / name).read_bytes()
    target = tsteps.state_struct(cfg)
    back = tckpt.restore(str(tmp_path / "b"), target, mesh=mesh1,
                         placements=pl)
    new, step, mesh = telastic.recover(str(tmp_path / "b"), lambda: None,
                                       target, 1, None, "cpu")
    assert step == 3 and tuple(mesh.shape) == (1, 1)
    for a, b, c in zip(ttree.leaves(state), ttree.leaves(back),
                       ttree.leaves(new)):
        assert b.placements == c.placements
        assert torch.equal(a, b.to_local()) and torch.equal(a, c.to_local())
