"""The port in a 2-rank gloo world on the CPU (tests/torch_mp_worker.py):
ZeRO-1 and the optimizer families on a data-parallel mesh, the SimCC
family, and the two ways of feeding several processes, each against JAX's
program on a (2, 1) mesh of the virtual CPU devices (tests/conftest.py).
The helpers and tolerances are tests/test_torch_parallel.py's.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from probpose_pytorch_tpu.train.config import OptimConfig as JaxOptim
from test_torch_parallel import _batch, _check_step, _ranks, _step_scenario, TINY
from torch_mp_worker import start_world, wait_world

WORLD = 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiprocess")
    job = tmp / "job"
    job.mkdir()
    batch = _batch()
    np.savez(job / "batch.npz", **batch)
    refs, scenarios = {}, {}
    for name, kw in (
        ("zero1", dict(steps=2, shard_opt_state=True)),
        ("lion", dict(steps=2, shard_opt_state=True,
                      optim=JaxOptim(peak_lr=1e-4, optimizer="lion"))),
        ("adafactor", dict(steps=2, shard_opt_state=True,
                           optim=JaxOptim(peak_lr=1e-4, optimizer="adafactor"))),
        ("simcc", dict(model=dict(head_type="simcc"))),
    ):
        refs[name], scenarios[name] = _step_scenario(job, tmp, name, batch, dp=WORLD, mp=1,
                                                     **kw)
    # one step of zero1's run, fed the global batch or each rank its slice
    for name, local in (("feed_global", False), ("feed_local", True)):
        scenarios[name] = dict(scenarios["zero1"], steps=1, local_batches=local)
    (job / "job.json").write_text(json.dumps({"presets": {"vit-tiny-par": TINY},
                                              "scenarios": scenarios}))
    handle = start_world(job, WORLD)
    try:  # JAX's mesh programs while the world runs
        for ref in refs.values():
            ref.pop("finish")()
    finally:
        wait_world(handle)
    return SimpleNamespace(job=job, refs=refs, size=WORLD)


def test_zero1_two_steps_match_jax(world):
    """ZeRO-1 over the data axis: two AdamW steps (the second reads the
    first's moments) == JAX's on its ZeRO-1 mesh, mu and nu gathered from
    their shards included; every moment of at least 1024 elements holds
    half its leaf on each rank."""
    ranks, out = _check_step(world, "zero1")
    whole = ranks[0]["param_numel"]
    local = ranks[0]["moment_numel"]
    split = [(w, m) for w, m in zip(whole, local) if w >= 1024]
    assert split and all(m * WORLD == w for w, m in split)
    assert all(m == w for w, m in zip(whole, local) if w < 1024)


@pytest.mark.parametrize("name", ["lion", "adafactor"])
def test_optimizer_families_on_dp_mesh_with_zero1(world, name):
    """Lion and Adafactor with ZeRO-1 on the data axis: two steps == JAX's,
    Lion's mu and Adafactor's rows, columns and v gathered from their
    shards included (Adafactor's factored rows and columns and block RMS
    span whole leaves: it gathers what it splits)."""
    _check_step(world, name)


def test_simcc_train_step_on_dp_mesh(world):
    """The SimCC family's loss has a data-dependent denominator (the
    weights' sum): the step on the gathered global batch is JAX's."""
    _, out = _check_step(world, "simcc")
    assert any("mlp_x" in k for k in out)


def test_two_process_feeding_matches(world):
    """Each rank fed its slice of the global batch (batch_iterator with
    process_index / process_count, the trainer's local_batches) takes the
    step of the global batch fed whole: the same loss on every rank, JAX's
    first ZeRO-1 step's."""
    ref = world.refs["zero1"]["losses"][0]
    for name in ("feed_global", "feed_local"):
        for r in _ranks(world, name):
            np.testing.assert_allclose(r["losses"][0], ref, rtol=1e-5)
    g = dict(np.load(world.job / "feed_global" / "out.npz"))
    loc = dict(np.load(world.job / "feed_local" / "out.npz"))
    for k in g:
        np.testing.assert_array_equal(g[k], loc[k], err_msg=k)
