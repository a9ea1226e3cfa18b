"""The comparison logic of ``scripts/c2_train_quality.py`` on the committed
JAX runs: the numbers it carries to the card (``scripts/c2_reference.json``)
are those of ``runs/*/metrics.jsonl`` and ``results.yaml``, the fp32 band of
the last-10 mean ``val/loss`` is 3.107e-4 to 3.264e-4, and a port run
outside [2.80e-4, 3.59e-4], or with a W2 mean above 1.5x the JAX run's or
not below its ``_dummy``, misses its limits."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("c2_train_quality",
                                               REPO / "scripts" / "c2_train_quality.py")
c2 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(c2)


@pytest.fixture(scope="module")
def ref() -> dict:
    return c2.load_reference()


def test_reference_is_the_committed_runs(ref) -> None:
    assert ref == json.loads(json.dumps(c2.reference_from_runs(REPO / "runs")))


def test_reference_carries_the_configs_as_written(ref) -> None:
    for name, (train, sample, _, _) in c2.RUNS.items():
        assert ref["configs"][name]["train"] == (REPO / "runs" / train /
                                                 "train_config.yaml").read_text()
        assert ref["configs"][name]["sample"] == (REPO / "runs" / sample /
                                                  "sample_config.yaml").read_text()


def test_fp32_band_of_the_six_runs(ref) -> None:
    low, high = ref["fp32_band"]
    assert round(low, 7) == 3.107e-4 and round(high, 7) == 3.264e-4
    assert c2.LOSS_LOW == pytest.approx(0.9 * 3.107e-4, abs=1e-6)
    assert c2.LOSS_HIGH == pytest.approx(1.1 * 3.264e-4, abs=1e-6)
    e_low, e_high = ref["fp32_epoch100_band"]
    assert 7.0e-4 <= e_low <= e_high <= 8.2e-4
    assert all(ref["losses"][r]["epochs"] == 600 for r in (*c2.FP32_RUNS, c2.BF16_RUN))


def _losses(mean: float) -> dict[int, float]:
    """A 600-epoch run whose last 10 epochs average ``mean``."""
    out = {e: 1e-3 for e in range(590)}
    out.update({590 + i: mean + (i - 4.5) * 1e-7 for i in range(10)})
    return out


def _w2(ref: dict, name: str, factor: float) -> dict:
    jax = ref["w2"][c2.RUNS[name][2]]
    return {k: factor * jax[k]["mean"] for k in c2.W2_KEYS}


@pytest.mark.parametrize("name", sorted(c2.RUNS))
@pytest.mark.parametrize("mean,ok", [(2.79e-4, False), (2.81e-4, True), (3.2e-4, True),
                                     (3.58e-4, True), (3.60e-4, False), (7.0e-4, False)])
def test_loss_limit(ref, name, mean, ok) -> None:
    summary = c2.loss_summary(_losses(mean))
    assert summary["last10_mean"] == pytest.approx(mean, rel=1e-9)
    missed = c2.check(name, summary, _w2(ref, name, 1.0), ref)
    assert (not missed) == ok, missed


@pytest.mark.parametrize("name", sorted(c2.RUNS))
@pytest.mark.parametrize("factor,ok", [(0.5, True), (1.0, True), (1.49, True), (1.51, False),
                                       (3.0, False)])
def test_w2_limit(ref, name, factor, ok) -> None:
    w2 = _w2(ref, name, factor)
    missed = c2.check(name, c2.loss_summary(_losses(3.2e-4)), w2, ref)
    assert (not missed) == ok, missed


@pytest.mark.parametrize("name", sorted(c2.RUNS))
def test_w2_must_lie_below_dummy(ref, name) -> None:
    """A W2 mean under 1.5x the JAX run's but at its ``_dummy`` misses."""
    w2 = {k: v["dummy"] for k, v in ref["w2"][c2.RUNS[name][2]].items()}
    factors = [w2[k] / ref["w2"][c2.RUNS[name][2]][k]["mean"] for k in c2.W2_KEYS]
    missed = c2.check(name, c2.loss_summary(_losses(3.2e-4)), w2, ref)
    assert len(missed) >= len(c2.W2_KEYS), (missed, factors)
    assert all("not below _dummy" in m or "above" in m for m in missed)


def test_epoch_losses_take_an_epoch_as_retrained(tmp_path) -> None:
    """A rolled-back epoch's last record counts; the rollback record none."""
    recs = [{"epoch": 0, "val/loss": 3.0}, {"epoch": 1, "val/loss": 9.0},
            {"rollback_from_epoch": 1, "rollback_to_epoch": 1},
            {"epoch": 1, "val/loss": 2.0}]
    path = tmp_path / "metrics.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert c2.epoch_losses(path) == {0: 3.0, 1: 2.0}
    assert c2.loss_summary(c2.epoch_losses(path)) == {"epochs": 2, "last10_mean": 2.5,
                                                      "epoch100": None}


def test_report_names_the_jax_runs(ref) -> None:
    line = c2.report("fp32", c2.loss_summary(_losses(3.2e-4)), _w2(ref, "fp32", 1.2), ref,
                     {"train": 1.0}, "card")
    assert line["missed"] == [] and line["config"] == "4ffeaa7e"
    for k in c2.W2_KEYS:
        assert set(line["w2"][k]) == {"port", "jax_193c5e46", "jax_71a51d58", "ratio", "dummy"}
        assert line["w2"][k]["ratio"] == pytest.approx(1.2)
