"""The port's data mesh (``fourierdiffusion_tpu_torch/parallel/``) on the
CPU: two real processes over gloo on ``127.0.0.1``, at a small size
(batch 8, L=16, 2 channels, d_model 8, 2 layers, 2 heads).

* ``DataMesh.rows`` covers a batch once; ``auto_data_mesh`` is ``None``
  with one rank and where the batch does not divide; both sets of
  variables (``FDIFF_*``, ``torchrun``'s) are read;
* a 2-rank ``Trainer.fit`` on the fused path (its plain version here),
  the unfused path (``FDIFF_FUSED_TRAIN=0``) and the MLP against the
  one-process fit, its replicas bit for bit;
* 2-rank ``em``/``ode``/``pc`` with the divergence guard on, gathered,
  against one process;
* the JAX trainer's data-parallel steps under ``make_mesh(2)`` against two
  port ranks that take their rows of JAX's draws;
* a loss spike that only one rank sees rolls every rank back together;
* a rank disagreeing with rank 0 fails ``assert_replicated_equal`` on every
  rank; ``dryrun_multichip(2)``.

Each spawn has its own time limit (``run_ranks`` kills the ranks past it,
and past any rank's failure; the collectives time out with it).

Tolerances. Every rank draws what the one process draws and keeps its
rows, so the runs part only where a sum over the batch is split over the
ranks (the gradients, the losses) or where a product over fewer chains
rounds otherwise (the CPU's matrix products): losses 1e-6 relative (fp32,
seen 1e-7); weights and EMA 1e-4 of each tensor's largest (seen 2e-7, but
4e-5 on the attention's key bias, whose gradient is zero in exact
arithmetic, so the rounding noise it holds is what AdamW normalises into
steps); samples 1e-6 of the largest |x| (seen 3.5e-7: an ulp of the
network's output over 25 steps); the guard's counts exactly.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import jax_and_port_models
from test_torch_training import VALUE, _jax_loss_draws

import _torch_parallel_worker as worker
from fourierdiffusion_tpu.parallel import make_mesh as jax_make_mesh
from fourierdiffusion_tpu.schedulers import VPScheduler as JaxVP
from fourierdiffusion_tpu.training import optim as jax_optim
from fourierdiffusion_tpu.training.trainer import Trainer as JaxTrainer
from fourierdiffusion_tpu.training.trainer import TrainStateBundle
from fourierdiffusion_tpu_torch.models.attention import SEED_MAX
from fourierdiffusion_tpu_torch.ops import flash_attention as fa
from fourierdiffusion_tpu_torch.ops import fused_encoder_train as fet
from fourierdiffusion_tpu_torch.parallel import (
    DataMesh,
    ShardedGenerator,
    auto_data_mesh,
    distributed,
)
from fourierdiffusion_tpu_torch.parallel import mesh as mesh_module
from fourierdiffusion_tpu_torch.parallel.dryrun import dryrun_multichip
from fourierdiffusion_tpu_torch.parallel.launch import run_ranks
from fourierdiffusion_tpu_torch.utils.weights import state_dict_from_jax

WORKER = Path(__file__).resolve().parent / "_torch_parallel_worker.py"
LOSS_RTOL, WEIGHT_TOL, SAMPLE_TOL = 1e-6, 1e-4, 1e-6
SPAWN_TIMEOUT = 240


def _spawn(tmp_path: Path, case: str, arg: str | None = None, env=None) -> list[dict]:
    argv = [sys.executable, str(WORKER), case, str(tmp_path)] + ([arg] if arg else [])
    run_ranks(argv, 2, timeout=SPAWN_TIMEOUT, env=env)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]


def _assert_weights_close(got: dict, want: dict, what: str) -> None:
    for name, w in want.items():
        err = (got[name] - w).abs().max().item() / max(w.abs().max().item(), 1e-12)
        assert err <= WEIGHT_TOL, f"{what} {name}: {err:.2e} of its largest"


# ---- the mesh and the environment ---------------------------------------------------


@pytest.mark.parametrize("world,batch", [(1, 8), (2, 8), (4, 64), (3, 12)])
def test_rows_cover_the_batch_once(world: int, batch: int) -> None:
    rows = [DataMesh(world, r, torch.device("cpu")).rows(batch) for r in range(world)]
    covered = [i for s in rows for i in range(batch)[s]]
    assert covered == list(range(batch))
    assert len({s.stop - s.start for s in rows}) == 1


def test_rows_refuse_a_batch_that_does_not_divide() -> None:
    with pytest.raises(ValueError, match="does not divide"):
        DataMesh(2, 0, torch.device("cpu")).rows(7)


@pytest.mark.parametrize("world", [2, 4])
def test_chain_seed_gives_each_rank_its_global_chains_masks(world: int) -> None:
    """Every hashed mask a rank draws with its shifted seed (B3/B4's four
    sites, B6's attention mask) is the whole batch's at the rank's rows, also
    where the shifted seed wraps past 2**32."""
    batch, seed, rate = 8, 2**32 - 5, 0.3
    whole = fet.dropout_masks(batch, 6, 4, 8, 2, seed, rate)
    whole_attn = fa.attention_keep(batch, 2, 6, seed, rate)
    for r in range(world):
        mesh = DataMesh(world, r, torch.device("cpu"))
        rows, n = mesh.rows(batch), batch // world
        local = mesh.chain_seed(seed, n)
        for site, m in fet.dropout_masks(n, 6, 4, 8, 2, local, rate).items():
            assert torch.equal(m, whole[site][rows]), (r, site)
        assert torch.equal(fa.attention_keep(n, 2, 6, local, rate), whole_attn[rows]), r


def test_batch_seed_shifts_only_a_sharded_stream() -> None:
    mesh = DataMesh(2, 1, torch.device("cpu"))

    def draw(g):
        return torch.randint(0, SEED_MAX, (3,), generator=g)

    plain = mesh_module.batch_seed(draw, 4, torch.Generator().manual_seed(0))
    sharded = mesh_module.batch_seed(
        draw, 4, ShardedGenerator(torch.Generator().manual_seed(0), mesh))
    assert torch.equal(plain, draw(torch.Generator().manual_seed(0)))
    assert torch.equal(sharded, (plain + 4 * 131071) & 0xFFFFFFFF)


def test_auto_data_mesh_is_none_for_one_rank_or_an_uneven_batch(monkeypatch) -> None:
    assert distributed.world_size() == 1
    assert auto_data_mesh() is None and auto_data_mesh(8) is None
    two = DataMesh(2, 0, torch.device("cpu"))
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(mesh_module, "make_mesh", lambda: two)
    assert auto_data_mesh(7) is None
    assert auto_data_mesh(8) is two and auto_data_mesh() is two


def test_distributed_env_reads_both_sets_of_variables() -> None:
    assert distributed.distributed_env({}) is None
    fdiff = {"FDIFF_COORDINATOR_ADDRESS": "host0:8476", "FDIFF_NUM_PROCESSES": "4",
             "FDIFF_PROCESS_ID": "3"}
    assert distributed.distributed_env(fdiff) == {
        "init_method": "tcp://host0:8476", "world_size": 4, "rank": 3, "local_rank": 3}
    torchrun = {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.2",
                "MASTER_PORT": "29500"}
    assert distributed.distributed_env(torchrun) == {
        "init_method": "tcp://10.0.0.2:29500", "world_size": 8, "rank": 5, "local_rank": 1}
    # The JAX package's variables come first where both sets are present.
    assert distributed.distributed_env({**torchrun, **fdiff})["rank"] == 3


@pytest.mark.parametrize("env", [
    {"FDIFF_COORDINATOR_ADDRESS": "h:1", "FDIFF_NUM_PROCESSES": "2"},
    {"FDIFF_NUM_PROCESSES": "2", "FDIFF_PROCESS_ID": "0"},
    {"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h"},
    {"FDIFF_COORDINATOR_ADDRESS": "h:1", "FDIFF_NUM_PROCESSES": "2", "FDIFF_PROCESS_ID": "2"},
])
def test_distributed_env_refuses_an_incomplete_or_wrong_set(env: dict) -> None:
    with pytest.raises(ValueError):
        distributed.distributed_env(env)


def test_initialize_is_a_no_op_without_the_variables(monkeypatch) -> None:
    for key in ("FDIFF_COORDINATOR_ADDRESS", "FDIFF_NUM_PROCESSES", "FDIFF_PROCESS_ID", "RANK",
                "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.maybe_initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary() and distributed.rank_device() is None


# ---- two ranks against one process --------------------------------------------------


@pytest.mark.parametrize("path", worker.PATHS)
def test_fit_on_two_ranks_equals_one_process(tmp_path: Path, monkeypatch, path: str) -> None:
    env = {"FDIFF_FUSED_TRAIN": "0" if path == "unfused" else "1"}
    ranks = _spawn(tmp_path, "fit", path, env)
    monkeypatch.setenv("FDIFF_FUSED_TRAIN", env["FDIFF_FUSED_TRAIN"])
    one = worker.fit(path, None)
    assert all(r["world_size"] == 2 for r in ranks)
    for k in ("params", "ema"):
        for name, t in ranks[0][k].items():
            assert torch.equal(t, ranks[1][k][name]), f"replicas differ: {k} {name}"
        _assert_weights_close(ranks[0][k], one[k], k)
    assert ranks[0]["history"] == ranks[1]["history"]
    for got, want in zip(ranks[0]["history"], one["history"], strict=True):
        assert got["step"] == want["step"]
        for key in ("train/loss", "val/loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)


def test_samplers_on_two_ranks_equal_one_process(tmp_path: Path) -> None:
    ranks = _spawn(tmp_path, "sample")
    one = worker.sample(None)
    for method in worker.METHODS:
        got, want = ranks[0][method], one[method]
        assert torch.equal(got["samples"], ranks[1][method]["samples"]), method
        assert got["stats"] == want["stats"] == ranks[1][method]["stats"], method
        assert want["stats"]["redraws"] > 0, f"{method}: the guard never redrew"
        assert got["samples"].shape == (worker.SAMPLE_CHAINS, worker.L, worker.C)
        scale = want["samples"].abs().max().item()
        err = (got["samples"] - want["samples"]).abs().max().item()
        assert err <= SAMPLE_TOL * scale, f"{method}: {err} at |x| up to {scale}"


def test_a_spike_one_rank_sees_rolls_back_every_rank(tmp_path: Path) -> None:
    """Rank 1's losses of epoch 6 spike; the reduced epoch loss makes both
    ranks rewind to epoch 5 under a new stream together (a rank rolling
    back alone would leave its peer in another collective)."""
    ranks = _spawn(tmp_path, "rollback")
    for r in ranks:
        assert r["epochs"] == list(range(worker.ROLLBACK_EPOCHS))
        assert r["salts"] == [0] * 5 + [1] * 3
        assert r["step"] == worker.ROLLBACK_EPOCHS * worker.datamodule().steps_per_epoch
    for name, t in ranks[0]["params"].items():
        assert torch.equal(t, ranks[1]["params"][name]), name


def test_replicas_that_differ_fail_on_every_rank(tmp_path: Path) -> None:
    ranks = _spawn(tmp_path, "disagree")
    assert [r["raised"] for r in ranks] == [True, True]


def test_jax_data_parallel_step_matches_two_ranks(tmp_path: Path, monkeypatch) -> None:
    """Two steps of the JAX trainer's epoch program under ``make_mesh(2)``
    (fused training forward in interpret mode, batch sharded over the
    ``data`` axis), against two port ranks that each take their rows of
    JAX's draws, shift their layer seeds to their first chain, all-reduce
    the gradients and step; to the one-process parity test's tolerance."""
    monkeypatch.setenv("FDIFF_FUSED_TRAIN", "1")
    length, batch, n_steps, n_total = 19, 4, 2, 20
    jmodel, variables, model = jax_and_port_models(
        length, worker.C, d_model=8, n_head=2, num_layers=2, dim_feedforward=16,
        dropout_rate=0.3)
    x_all = np.random.default_rng(6).normal(size=(10, length, worker.C)).astype(np.float32)
    perm = np.array([[3, 1, 7, 0], [9, 2, 5, 4]])
    key = jax.random.PRNGKey(11)
    jsched = JaxVP(fourier_noise_scaling=True)
    jtrainer = JaxTrainer(jmodel, jsched, lr_max=1e-3, ema_decay=0.999, mesh=jax_make_mesh(2))
    opt = jax_optim.make_optimizer(1e-3, n_total)
    train_epoch, _ = jtrainer._make_epoch_fns(opt)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    constants = jax.tree_util.tree_map(jnp.asarray, variables["constants"])
    draws = []
    for k in jax.random.split(key, n_steps):
        drop_key, loss_key = jax.random.split(k)
        seeds = [int(jax.random.randint(jax.random.fold_in(drop_key, i), (), 0,
                                        jnp.iinfo(jnp.int32).max)) for i in range(2)]
        draws.append((*_jax_loss_draws(loss_key, (batch, length, worker.C), jsched), seeds))
    state = TrainStateBundle(params, constants, opt.init(params), jnp.zeros((), jnp.int32),
                             jax.tree_util.tree_map(jnp.copy, params))
    state, mean_loss = train_epoch(state, jnp.asarray(x_all), jnp.asarray(perm), key)

    names = dict(model.named_parameters())
    npz = tmp_path / "jax_step.npz"
    np.savez(npz, x=x_all[perm], t=np.stack([d[0] for d in draws]),
             z=np.stack([d[1] for d in draws]), seeds=np.array([d[2] for d in draws]),
             n_total=n_total, **{f"w/{n}": v.numpy() for n, v in model.state_dict().items()},
             **{f"want/{n}": state_dict_from_jax(
                 {"params": jax.tree_util.tree_map(np.asarray, state.params)}, 2)[n].numpy()
                for n in names})
    ranks = _spawn(tmp_path, "jax_step", str(npz))
    want_ema = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                                      state.ema_params)}, 2)
    want = np.load(npz)
    assert ranks[0]["step"] == ranks[1]["step"] == int(state.step) == n_steps
    np.testing.assert_allclose(ranks[0]["loss"], float(mean_loss), **VALUE)
    for name in names:
        np.testing.assert_allclose(ranks[0]["params"][name].numpy(), want[f"want/{name}"],
                                   **VALUE, err_msg=name)
        np.testing.assert_allclose(ranks[0]["ema"][name].numpy(), want_ema[name].numpy(),
                                   **VALUE, err_msg=name)
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name


def test_dryrun_multichip_on_the_cpu() -> None:
    """At 16 chains in place of 512: ``chip_smoke.py`` phase 19 (d) runs
    the 512 on the card."""
    outputs = dryrun_multichip(2, chains=16, timeout=600)
    assert all(f"rank {r}: dryrun_multichip OK" in out for r, out in enumerate(outputs))
    assert all("16 chains (8 per rank) OK" in out for out in outputs)


def test_a_failing_rank_ends_its_peers(tmp_path: Path) -> None:
    """Rank 1 exits at once; rank 0 waits in a collective that never
    completes: ``run_ranks`` must end it and raise, well inside its limit."""
    script = tmp_path / "stuck.py"
    script.write_text(
        "import os, sys, torch\n"
        "from fourierdiffusion_tpu_torch.parallel import distributed\n"
        "distributed.maybe_initialize_distributed(device='cpu')\n"
        "if distributed.rank() == 1:\n"
        "    sys.exit(3)\n"
        "distributed.barrier()\n"
    )
    with pytest.raises(RuntimeError, match="rank 1 exited with 3"):
        run_ranks([sys.executable, str(script)], 2, timeout=120)


@pytest.fixture(autouse=True)
def _two_threads_in_the_test_process():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

