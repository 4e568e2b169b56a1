"""The port's distribution layer on several ranks, held against the
reference on its (2, 2) mesh of jax CPU devices.

A module fixture spawns the ranks twice, as a user would:

* ``python -m torch.distributed.run --standalone --nproc-per-node 4 -m
  repro_torch.benchmarks.dist_smoke --device cpu`` on inputs this file
  draws from numpy seeds, which the reference gets too;
* the training driver under the same launcher with ``--model-parallel
  2``, resuming from the reference's step-3 checkpoint of the same run.

Both run while the reference computes here. Tolerances, as the
reference's own tests hold its sharded values (``tests/test_sharding.py``,
``tests/test_granularity.py``): the expert-parallel layer rtol 1e-4, atol
1e-5; its gradients against the dense oracle's rtol 1e-3, atol 1e-4; the
sequence-sharded decode rtol 1e-5, atol 1e-5; the sharded step's loss
rtol 2e-5 and grads rtol 1e-3, atol 1e-4 (the grad norm rtol 1e-4); the
driver's losses rtol 1e-4. Exact: the int8 reduction, checkpoint bytes,
the elastic restore, the shards' shapes. The prefill and decode arms
against the port's single-process prefill and decode: rtol 1e-5, atol
1e-5 (the ranks' products have other row counts).

MoE routing over the data ranks (``ROUTE_CASES``): ``TINY_MOE_CFG`` under
``tp`` and ``fsdp`` with LW+ at capacity factors 1.25 and 0.5 and with
SW+, held to the reference's (2, 2) sharded step (loss, ce and aux rtol
2e-5; grads rtol 1e-3, atol 1e-4; SW+ has no backward, in either
package, so its loss alone) and to its sharded prefill and decode (rtol
1e-5, atol 1e-5): the layer routes the global batch, as GSPMD does.
The ``ssm`` and ``hybrid`` families (``FAMILY_CASES``: the
``mamba2-780m`` and ``hymba-1.5b`` smoke configs, float32, tp_divisor
2) under ``tp`` and ``fsdp``, held the same way.

Every case computes its rank's shards (tensor parallelism over "model",
FSDP shards gathered a layer at a time): under ``tp`` the step and its
arms issue no all-gather over "model" at all (``launch.mesh``'s counts),
the sharder finds each named activation its spec's local block, and
under ``fsdp`` with remat at most two layers' gathered weights are alive
at once (one, measured; all of them without remat, where autograd saves
them).

The ``gpu`` tests run ``chip_smoke.py``'s distribution phase (a)–(f) on
a card, a world of one ((f): rank 0's local step of the dry run's
tinyllama cell in a child process, on a fake group of 512 ranks).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as ttree
from repro_torch.benchmarks import dist_smoke
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import registry as tregistry
from repro_torch.launch import steps as tsteps
from repro_torch.models import convert
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TModelConfig

try:
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from repro import sharding as rsharding
    from repro.checkpoint import ckpt as rckpt
    from repro.core import granularity as rgran
    from repro.launch import steps as rsteps
    from repro.launch import train as rtrain
    from repro.models import model as rmodel
    from repro.models.config import ModelConfig as RModelConfig
    from repro.models.config import ShapeConfig as RShapeConfig
    from repro.optim import adamw as radamw
    from repro.optim import compression as rcomp
except ImportError:     # a machine with a card and no jax: gpu tests only
    jax = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 300
EP_CFG = dict(name="g-moe", family="moe", d_model=64, n_heads=4,
              n_kv_heads=4, head_dim=16, d_ff=0, vocab_size=128,
              moe_experts=8, moe_shared=0, moe_top_k=2, moe_d_ff=32,
              moe_capacity_factor=8.0, dtype="float32", tp_divisor=2)
CAPACITY_FACTORS = (8.0, 0.1)
# The reference's _tiny_cfg (tests/test_sharding.py), and a MoE of its
# size for the swep layout.
TINY_CFG = dict(name="shard-t", family="dense", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
                dtype="float32", tp_divisor=2)
TINY_MOE_CFG = dict(TINY_CFG, name="shard-moe", family="moe", d_ff=0,
                    moe_experts=4, moe_top_k=2, moe_d_ff=16)
LAYOUT_CFGS = {"tp": TINY_CFG, "fsdp": TINY_CFG, "swep": TINY_MOE_CFG}
# MoE routing over the data ranks under tp and fsdp: LW+ at the default
# capacity factor and at one that drops tokens (the global capacity then
# differs from a rank's), and SW+ (no drops: the aux term alone). One
# case recomputes its layers in the backward (remat "full"), where the
# routing's collectives run again.
MOE_ROUTE_CFGS = {
    "lw_plus-cf1.25": dict(TINY_MOE_CFG, moe_capacity_factor=1.25),
    "lw_plus-cf0.5": dict(TINY_MOE_CFG, moe_capacity_factor=0.5),
    "sw_plus": dict(TINY_MOE_CFG, moe_dispatch="sw_plus"),
}
ROUTE_CASES = {f"{layout}-{name}": (layout, dict(
    cfg, remat="full" if (layout, name) == ("fsdp", "lw_plus-cf0.5")
    else "none")) for layout in ("tp", "fsdp")
    for name, cfg in MOE_ROUTE_CFGS.items()}


def _smoke_cfg(arch):
    cfg = tregistry.get_config(arch, smoke=True)
    return dict(dataclasses.asdict(cfg), dtype="float32", tp_divisor=2)


# The ssm and hybrid families (their tp case recomputes its layers with
# remat "dots", under which each layer's FSDP gathers run again).
FAMILY_CFGS = {"ssm": _smoke_cfg("mamba2-780m"),
               "hybrid": _smoke_cfg("hymba-1.5b")}
FAMILY_CASES = {f"{layout}-{fam}": (layout, dict(
    cfg, remat="dots" if layout == "tp" else "none"))
    for layout in ("tp", "fsdp") for fam, cfg in FAMILY_CFGS.items()}
ARM_CASES = dict(ROUTE_CASES, **FAMILY_CASES)
STEP_CASES = dict({layout: (layout, cfg) for layout, cfg in
                   LAYOUT_CFGS.items()}, **ARM_CASES)
TRAIN_ARGS = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "6",
              "--batch", "8", "--seq-len", "32", "--ckpt-every", "3",
              "--log-every", "1", "--model-parallel", "2"]


def _need_reference():
    if jax is None:
        pytest.skip("needs jax, the reference package's framework")


def _spawn(args, work, name):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    out = open(os.path.join(work, name + ".out"), "w")
    err = open(os.path.join(work, name + ".err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4"] + args, cwd=work, env=env, stdout=out,
        stderr=err)
    return proc, out, err


def _finish(spawned, work, name):
    proc, out, err = spawned
    try:
        rc = proc.wait(timeout=SPAWN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()
    text = open(os.path.join(work, name + ".out")).read()
    if rc != 0:
        tail = open(os.path.join(work, name + ".err")).read()[-4000:]
        raise AssertionError(f"{name}: exit {rc}\n{text[-2000:]}\n{tail}")
    return text


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    out = {}
    ep_cfg = TModelConfig(**EP_CFG).validate()
    for k, v in tmoe.moe_init(convert.NumpyInit(1), ep_cfg,
                              torch.float32).items():
        out["ep/" + k] = v
    out["ep/cfg"] = json.dumps(EP_CFG)
    out["ep/capacity_factors"] = np.asarray(CAPACITY_FACTORS)
    out["ep/x"] = rng.standard_normal((4, 16, 64)).astype(f32)
    out["ep/ct"] = rng.standard_normal((4, 16, 64)).astype(f32)
    out["decode/q"] = rng.standard_normal((2, 3, 16)).astype(f32)
    out["decode/k"] = rng.standard_normal((2, 32, 3, 16)).astype(f32)
    out["decode/v"] = rng.standard_normal((2, 32, 3, 16)).astype(f32)
    positions = np.arange(32, dtype=np.int32)
    positions[20:] = -1
    out["decode/positions"] = positions
    out["decode/pos"] = np.asarray(19)
    out["compress/a"] = (rng.standard_normal((2, 64)) * 1e-2).astype(f32)
    b = (rng.standard_normal((2, 8, 16)) * 1e-2).astype(f32)
    out["compress/b"] = b.astype(ml_dtypes.bfloat16).astype(f32)
    out["step_cases"] = json.dumps(list(STEP_CASES))
    for case, (layout, cfg_dict) in STEP_CASES.items():
        key = "step_" + case
        cfg = TModelConfig(**cfg_dict).validate()
        out[key + "/cfg"] = json.dumps(cfg_dict)
        out[key + "/layout"] = layout
        for path, leaf in ttree.flatten(convert.numpy_params(cfg, 5)):
            out[key + "/params/" + "/".join(path)] = leaf
        out[key + "/tokens"] = rng.integers(0, 64, (4, 16)).astype(np.int32)
        # fsdp's arms shard a batch that divides every rank over both
        # axes and its cache's heads over "model" again, which the
        # reference refuses too: a batch of 2 shards over "data" alone.
        pb = 2 if layout == "fsdp" else 4
        out[key + "/prompt"] = rng.integers(0, 64, (pb, 8)).astype(np.int32)
        out[key + "/next"] = rng.integers(0, 64, (pb, 1)).astype(np.int32)
        out[key + "/max_len"] = np.asarray(16)
    return out


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))


def _reference_ep(inputs):
    mesh = _mesh()
    params = {k: jnp.asarray(inputs["ep/" + k])
              for k in ("router", "w1", "w3", "w2")}
    x = jnp.asarray(inputs["ep/x"])
    out = {}
    rgran.set_mesh(mesh, ("data",))
    try:
        for i, cf in enumerate(CAPACITY_FACTORS):
            cfg = RModelConfig(**dict(EP_CFG, moe_capacity_factor=cf)
                               ).validate()
            with mesh:
                y, aux = jax.jit(lambda p, x: rgran.sw_plus_ep_layer(
                    p, x, cfg, ("data",), block=8))(params, x)
            out[f"y{i}"] = np.asarray(y)
            out[f"aux{i}"] = np.asarray(aux)
        with mesh:
            out["decode"] = np.asarray(jax.jit(
                lambda q, k, v: rgran.seq_sharded_decode_attention(
                    q, k, v, jnp.asarray(inputs["decode/positions"]),
                    jnp.asarray(19), mesh=mesh))(
                *(jnp.asarray(inputs["decode/" + n]) for n in "qkv")))
    finally:
        rgran.set_mesh(None)
    return out


def _oracle_grads(inputs):
    """The gradients of sum(y * ct) through the port's dense oracle, in
    one process."""
    cfg = TModelConfig(**EP_CFG).validate()
    params = {k: torch.from_numpy(inputs["ep/" + k]).requires_grad_()
              for k in ("router", "w1", "w3", "w2")}
    x = torch.from_numpy(inputs["ep/x"]).reshape(-1, 64).requires_grad_()
    y, _ = tmoe.dispatch_dense_oracle(params, x, cfg)
    (y * torch.from_numpy(inputs["ep/ct"]).reshape(-1, 64)).sum().backward()
    out = {"d" + k: p.grad.numpy() for k, p in params.items()}
    out["dx"] = x.grad.reshape(4, 16, 64).numpy()
    out["y"] = y.detach().numpy()
    return out


def _reference_compress(inputs):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    grads = {"a": jax.device_put(jnp.asarray(inputs["compress/a"]), sh),
             "b": jax.device_put(jnp.asarray(inputs["compress/b"]).astype(
                 jnp.bfloat16), sh)}
    red = rcomp.compressed_psum_grads(grads, mesh, axis="data")
    return {"a": np.asarray(red["a"]),
            "b_bits": np.asarray(red["b"]).view(np.int16)}


def _reference_step(inputs, case):
    """The reference's loss and grads of train_loss on its (2, 2) mesh in
    `case`'s layout, as tests/test_sharding.py computes them (a sw_plus
    MoE: the loss and metrics alone, as pallas_call has no transpose
    rule); and its prefill and decode arms there, for a MoE."""
    key = "step_" + case
    layout, cfg_dict = STEP_CASES[case]
    cfg = RModelConfig(**cfg_dict).validate()
    if layout == "swep":
        cfg = dataclasses.replace(cfg, moe_dispatch="sw_plus_ep")
    params = jax.tree.map(jnp.asarray, dist_smoke._tree(
        inputs, key + "/params"))
    toks = jnp.asarray(inputs[key + "/tokens"])
    batch = {"tokens": toks, "labels": toks}
    mesh = _mesh()
    if layout == "fsdp":
        dp = ("data", "model")
    else:
        dp = rsharding.data_axes(mesh, toks.shape[0])
    p_sh = jax.device_put(params, rsharding.to_named(
        mesh, rsharding.param_specs(params, layout)))
    b_sh = jax.device_put(batch, rsharding.to_named(
        mesh, rsharding.batch_specs(batch, dp)))
    sharder = rsharding.make_sharder(mesh, dp, layout)
    rgran.set_mesh(mesh, dp)
    try:
        with mesh:
            if cfg.moe_dispatch == "sw_plus":
                loss, metrics = jax.jit(lambda p, b: rmodel.train_loss(
                    p, cfg, b, sharder))(p_sh, b_sh)
                grads = None
            else:
                (loss, metrics), grads = jax.jit(jax.value_and_grad(
                    lambda p, b: rmodel.train_loss(p, cfg, b, sharder),
                    has_aux=True))(p_sh, b_sh)
    finally:
        rgran.set_mesh(None)
    out = {"loss": float(loss), "ce": float(metrics["ce"]),
           "aux": float(metrics["aux"]), "tokens": float(metrics["tokens"])}
    if grads is not None:
        out["grad_norm"] = float(radamw.global_norm(grads))
        out["grads"] = {"/".join(str(getattr(k, "key", k)) for k in path):
                        np.asarray(g) for path, g in
                        jax.tree_util.tree_flatten_with_path(grads)[0]}
    if case in ARM_CASES:
        out["arms"] = _reference_arms(inputs, key, cfg, layout, params)
    return out


def _reference_arms(inputs, key, cfg, layout, params):
    """The reference's prefill and one decode step on its (2, 2) mesh,
    jitted with build_step's shardings."""
    mesh = _mesh()
    prompt = jnp.asarray(inputs[key + "/prompt"])
    pshape = RShapeConfig(name="p", seq_len=int(inputs[key + "/max_len"]),
                          global_batch=prompt.shape[0], kind="prefill")
    try:
        with mesh:
            pre, _, pin, pout = rsteps.build_step(cfg, pshape, mesh,
                                                  layout=layout)
            logits, cache = jax.jit(pre, in_shardings=pin,
                                    out_shardings=pout)(
                params, {"tokens": prompt})
            dec, _, din, dout = rsteps.build_step(
                cfg, dataclasses.replace(pshape, kind="decode"), mesh,
                layout=layout)
            dlogits, cache = jax.jit(dec, in_shardings=din,
                                     out_shardings=dout)(
                params, jnp.asarray(inputs[key + "/next"]), cache)
    finally:
        rgran.set_mesh(None)
    out = {"prefill_logits": np.asarray(logits),
           "decode_logits": np.asarray(dlogits)}
    if "kv" in cache:
        out["decode_k"] = np.asarray(cache["kv"]["k"])
    if "ssm" in cache:
        out.update(decode_h=np.asarray(cache["ssm"]["h"]),
                   decode_conv_x=np.asarray(cache["ssm"]["conv_x"]))
    return out


def _plain_arms(inputs, layout):
    """The port's single-process prefill and one decode step."""
    key = "step_" + layout
    cfg = TModelConfig(**LAYOUT_CFGS[layout]).validate()
    params = convert.params_from_numpy(dist_smoke._tree(
        inputs, key + "/params"), cfg, "cpu")
    logits, cache = tsteps.make_prefill_step(cfg, 16)(
        params, {"tokens": torch.from_numpy(inputs[key + "/prompt"])})
    dlogits, cache = tsteps.make_serve_step(cfg)(
        params, torch.from_numpy(inputs[key + "/next"]), cache)
    return {"prefill_logits": logits.numpy(),
            "decode_logits": dlogits.numpy(),
            "decode_k": cache["kv"]["k"].numpy()}


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    _need_reference()
    work = str(tmp_path_factory.mktemp("dist"))
    inputs = _inputs()
    np.savez(os.path.join(work, "in.npz"), **inputs)
    smoke = _spawn(["-m", "repro_torch.benchmarks.dist_smoke", "--device",
                    "cpu", "--inputs", os.path.join(work, "in.npz"),
                    "--out", os.path.join(work, "out.npz")], work, "smoke")
    train = None
    try:
        ref_dir = os.path.join(work, "ref_ckpt")
        ref_train = rtrain.main(TRAIN_ARGS + ["--ckpt-dir", ref_dir])
        port_dir = os.path.join(work, "port_ckpt")
        shutil.copytree(os.path.join(ref_dir, "step_00000003"),
                        os.path.join(port_dir, "step_00000003"))
        train = _spawn(["-m", "repro_torch.launch.train"] + TRAIN_ARGS
                       + ["--ckpt-dir", port_dir, "--device", "cpu"],
                       work, "train")
        ref = {"ep": _reference_ep(inputs), "oracle": _oracle_grads(inputs),
               "compress": _reference_compress(inputs),
               "step": {c: _reference_step(inputs, c) for c in STEP_CASES},
               "arms": {l: _plain_arms(inputs, l) for l in ("tp", "fsdp")}}
    finally:
        smoke_text = _finish(smoke, work, "smoke")
        train_text = _finish(train, work, "train") if train else ""
    with np.load(os.path.join(work, "out.npz")) as f:
        got = dict(f)
    return {"got": got, "ref": ref, "inputs": inputs, "ref_train": ref_train,
            "train_text": train_text, "smoke_text": smoke_text,
            "ref_dir": ref_dir, "port_dir": port_dir}


# ------------------------------------------------- expert-parallel SW+


@pytest.mark.parametrize("i", range(len(CAPACITY_FACTORS)),
                         ids=[f"cf{c}" for c in CAPACITY_FACTORS])
def test_sw_plus_ep_layer_matches_reference(dist_run, i):
    got, ref = dist_run["got"], dist_run["ref"]["ep"]
    np.testing.assert_allclose(got[f"ep/y{i}"], ref[f"y{i}"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got[f"ep/aux{i}"], ref[f"aux{i}"], rtol=1e-5)


def test_tight_budget_drops_assignments_as_the_reference(dist_run):
    """At capacity factor 0.1 both packages drop assignments (the output
    leaves the dense oracle's), and the same ones (they agree above)."""
    oracle = dist_run["ref"]["oracle"]["y"].reshape(4, 16, 64)
    gap = np.abs(dist_run["got"]["ep/y1"] - oracle).max()
    assert gap > 1e-2
    assert np.abs(dist_run["ref"]["ep"]["y1"] - oracle).max() > 1e-2
    np.testing.assert_allclose(dist_run["got"]["ep/y0"], oracle, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["dx", "drouter", "dw1", "dw3", "dw2"])
def test_sw_plus_ep_grads_match_dense_oracle(dist_run, name):
    np.testing.assert_allclose(dist_run["got"]["ep/" + name],
                               dist_run["ref"]["oracle"][name], rtol=1e-3,
                               atol=1e-4)


def test_seq_sharded_decode_matches_reference(dist_run):
    np.testing.assert_allclose(dist_run["got"]["decode/out"],
                               dist_run["ref"]["ep"]["decode"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("leaf", ["a", "b_bits"])
def test_compressed_psum_matches_reference_bit_for_bit(dist_run, leaf):
    got = dist_run["got"]["compress/" + leaf]
    want = dist_run["ref"]["compress"][leaf]
    assert got.dtype == want.dtype and np.array_equal(got, want)


# --------------------------------------------------- build_step on 2x2


@pytest.mark.parametrize("layout", list(LAYOUT_CFGS))
def test_build_step_loss_matches_reference(dist_run, layout):
    got, ref = dist_run["got"], dist_run["ref"]["step"][layout]
    key = "step_" + layout
    np.testing.assert_allclose(got[key + "/loss"], ref["loss"], rtol=2e-5)
    np.testing.assert_allclose(got[key + "/ce"], ref["ce"], rtol=2e-5)
    assert float(got[key + "/tokens"]) == ref["tokens"]
    # the step's own loss and global grad norm
    np.testing.assert_allclose(got[key + "/step_loss"], ref["loss"],
                               rtol=2e-5)
    np.testing.assert_allclose(got[key + "/grad_norm"], ref["grad_norm"],
                               rtol=1e-4)


@pytest.mark.parametrize("layout", list(LAYOUT_CFGS))
def test_build_step_grads_match_reference(dist_run, layout):
    got, ref = dist_run["got"], dist_run["ref"]["step"][layout]["grads"]
    prefix = f"step_{layout}/grads/"
    keys = {k[len(prefix):] for k in got if k.startswith(prefix)}
    assert keys == set(ref)
    for k in sorted(keys):
        np.testing.assert_allclose(got[prefix + k], ref[k], rtol=1e-3,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUT_CFGS))
def test_build_step_shards_have_their_spec_shapes(dist_run, layout):
    assert bool(dist_run["got"][f"step_{layout}/shards_ok"])


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("name", ["prefill_logits", "decode_logits",
                                  "decode_k"])
def test_prefill_and_decode_arms_match_one_process(dist_run, layout, name):
    np.testing.assert_allclose(dist_run["got"][f"step_{layout}/{name}"],
                               dist_run["ref"]["arms"][layout][name],
                               rtol=1e-5, atol=1e-5)


# ------------------------------- MoE routing over the data ranks (tp/fsdp)


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_moe_routing_loss_and_aux_match_reference(dist_run, case):
    """A MoE layer under tp/fsdp routes the global batch: its balance term
    and LW+'s capacity and positions are the global batch's."""
    got, ref = dist_run["got"], dist_run["ref"]["step"][case]
    key = "step_" + case
    for name in ("loss", "ce", "aux"):
        np.testing.assert_allclose(got[f"{key}/{name}"], ref[name],
                                   rtol=2e-5, err_msg=name)
    assert float(got[key + "/tokens"]) == ref["tokens"]
    if "grads" in ref:
        np.testing.assert_allclose(got[key + "/step_loss"], ref["loss"],
                                   rtol=2e-5)
        np.testing.assert_allclose(got[key + "/grad_norm"],
                                   ref["grad_norm"], rtol=1e-4)


@pytest.mark.parametrize("case", [c for c in ROUTE_CASES
                                  if "sw_plus" not in c])
def test_moe_routing_grads_match_reference(dist_run, case):
    got, ref = dist_run["got"], dist_run["ref"]["step"][case]["grads"]
    prefix = f"step_{case}/grads/"
    keys = {k[len(prefix):] for k in got if k.startswith(prefix)}
    assert keys == set(ref)
    for k in sorted(keys):
        np.testing.assert_allclose(got[prefix + k], ref[k], rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    assert bool(got[f"step_{case}/shards_ok"])


@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("name", ["prefill_logits", "decode_logits",
                                  "decode_k"])
def test_moe_routing_arms_match_reference(dist_run, case, name):
    np.testing.assert_allclose(dist_run["got"][f"step_{case}/{name}"],
                               dist_run["ref"]["step"][case]["arms"][name],
                               rtol=1e-5, atol=1e-5)


# ------------------------------------- the ssm and hybrid families


def _arm_names(case):
    fam = FAMILY_CASES[case][1]["family"]
    return (["prefill_logits", "decode_logits"]
            + (["decode_k"] if fam == "hybrid" else [])
            + ["decode_h", "decode_conv_x"])


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_family_step_loss_matches_reference(dist_run, case):
    got, ref = dist_run["got"], dist_run["ref"]["step"][case]
    key = "step_" + case
    for name in ("loss", "ce", "step_loss"):
        np.testing.assert_allclose(got[f"{key}/{name}"],
                                   ref["ce" if name == "ce" else "loss"],
                                   rtol=2e-5, err_msg=name)
    assert float(got[key + "/tokens"]) == ref["tokens"]
    np.testing.assert_allclose(got[key + "/grad_norm"], ref["grad_norm"],
                               rtol=1e-4)
    assert bool(got[key + "/shards_ok"])


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_family_step_grads_match_reference(dist_run, case):
    got, ref = dist_run["got"], dist_run["ref"]["step"][case]["grads"]
    prefix = f"step_{case}/grads/"
    keys = {k[len(prefix):] for k in got if k.startswith(prefix)}
    assert keys == set(ref)
    for k in sorted(keys):
        np.testing.assert_allclose(got[prefix + k], ref[k], rtol=1e-3,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_family_arms_match_reference(dist_run, case):
    got, ref = dist_run["got"], dist_run["ref"]["step"][case]["arms"]
    for name in _arm_names(case):
        np.testing.assert_allclose(got[f"step_{case}/{name}"], ref[name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# ---------------------------- the rank's shards: collectives, sharder


def _counts(dist_run, case, which="counts"):
    return json.loads(str(dist_run["got"][f"step_{case}/{which}"]))


@pytest.mark.parametrize("case", [c for c, (layout, _) in STEP_CASES.items()
                                  if layout in ("tp", "swep")])
def test_tp_never_all_gathers_over_model(dist_run, case):
    """Under tp (and swep) no TP-sharded parameter, and no tensor at all,
    is all-gathered over "model", in the step or its arms; the layers'
    Megatron sums over "model" and, but for swep's experts, FSDP's
    gathers over "data" run."""
    for which in ("counts", "arm_counts"):
        if f"step_{case}/{which}" not in dist_run["got"]:
            continue                         # swep has no arms
        counts = _counts(dist_run, case, which)
        assert counts.get("model/all_gather", 0) == 0, (which, counts)
        assert counts.get("model/all_reduce", 0) > 0, (which, counts)
        assert counts.get("data/all_gather", 0) > 0, (which, counts)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharder_checks_every_named_activation(dist_run, case):
    """The sharder's names were each checked (a local block of its spec,
    or the run raises): hidden and logits in every case, expert_in where
    LW+ builds its capacity buffer."""
    layout, cfg = STEP_CASES[case]
    want = {"hidden", "logits"}
    if cfg["family"] == "moe" and layout != "swep" and \
            cfg.get("moe_dispatch", "lw_plus") == "lw_plus":
        want.add("expert_in")
    assert set(json.loads(str(dist_run["got"][f"step_{case}/checked"]))) \
        == want


def test_fsdp_gathers_at_most_two_layers_at_once(dist_run):
    """Under fsdp with remat, the gathered weights of at most two layers
    (measured: one) are alive at once; without remat autograd keeps every
    layer's for the backward, which the count sees."""
    got = dist_run["got"]
    assert int(got["live_full"]) <= 2 and int(got["live_dots"]) <= 2
    assert int(got["live_none"]) == dist_smoke.LIVE_LAYERS


def test_elastic_recover_onto_half_the_ranks(dist_run):
    assert bool(dist_run["got"]["elastic/ok"])


# ------------------------------------------------ the driver on 4 ranks


def _port_losses(text):
    steps, last = {}, None
    for line in text.splitlines():
        parts = line.split()
        if parts[:1] == ["step"]:
            steps[int(parts[1])] = float(parts[3])
        elif line.startswith("{"):
            last = json.loads(line)
    return steps, last


def test_train_cli_model_parallel_matches_reference(dist_run):
    """Steps 3-5 of the port's driver on a (2, 2) mesh, resumed from the
    reference's step-3 checkpoint, against the reference's run."""
    ref = dist_run["ref_train"]["losses"]
    steps, last = _port_losses(dist_run["train_text"])
    assert sorted(steps) == [3, 4, 5]
    for s, printed in steps.items():
        assert abs(printed - ref[s]) <= 1e-4 * abs(ref[s]) + 5e-5, s
    np.testing.assert_allclose(last["first_loss"], ref[3], rtol=1e-4)
    np.testing.assert_allclose(last["last_loss"], ref[5], rtol=1e-4)
    assert last["final_step"] == 6


def _npz_bits(path):
    with np.load(os.path.join(path, "step_00000006", "host_0.npz")) as f:
        return {k: np.asarray(v) for k, v in f.items()}


def test_port_checkpoint_restores_in_reference_with_equal_bytes(dist_run):
    cfg = rtrain.get_config("tinyllama-1.1b", smoke=True)
    target = jax.eval_shape(lambda: {
        "params": rmodel.init_params(jax.random.PRNGKey(0), cfg),
        "opt": radamw.init(rmodel.init_params(jax.random.PRNGKey(0), cfg))})
    back = rckpt.restore(dist_run["port_dir"], target, step=6)
    files = _npz_bits(dist_run["port_dir"])
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert len(flat) == len(files)
    for path, leaf in flat:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        a = np.asarray(leaf)
        assert a.tobytes() == files[key].tobytes(), key


def test_reference_checkpoint_restores_in_port_with_equal_bytes(dist_run):
    cfg = tregistry.get_config("tinyllama-1.1b", smoke=True)
    back = tckpt.restore(dist_run["ref_dir"], tsteps.state_struct(cfg),
                         step=6)
    files = _npz_bits(dist_run["ref_dir"])
    for path, leaf in ttree.flatten(back):
        assert tckpt.to_numpy(leaf).tobytes() == \
            files["/".join(path)].tobytes(), path


# ------------------------------------------------------------- the card


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.gpu
def test_dense_mesh_step_is_the_plain_step_on_card(card):
    out = dist_smoke.dense_step_check(card)
    assert out["mesh"]["losses"] == out["plain"]["losses"]
    dist_smoke.compression_check(out["cfg"], out["args"], out["state"],
                                 out["device_mesh"], out["get_batch"])


@pytest.mark.gpu
def test_moe_layer_and_swep_training_on_card(card):
    out = dist_smoke.moe_check(card)
    assert len(out["swep_losses"]) == dist_smoke.SWEP_STEPS


@pytest.mark.gpu
def test_elastic_recover_on_card(card):
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    import tempfile
    with tempfile.TemporaryDirectory(dir=build) as work:
        out = dist_smoke.elastic_check(card, work)
    assert out["leaves"] > 0


@pytest.mark.gpu
def test_seq_sharded_decode_on_card(card):
    assert dist_smoke.decode_check(card)["max_abs_err"] < 1e-3


@pytest.mark.gpu
def test_rank0_local_step_of_the_dry_run_cell_on_card(card, tmp_path):
    out = dist_smoke.rank0_check(card, str(tmp_path))
    assert out["rows"] == 16 and out["peak_bytes"] < dist_smoke.CARD_BYTES
