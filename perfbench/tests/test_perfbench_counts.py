"""The frozen work counts and the per-layer readers' arithmetic."""

import json

import pytest

from perfbench import counts, harness

ROOT = harness.ROOT


def cfg(model):
    return json.loads((ROOT / "perfbench" / "configs" / f"{model}.json")
                      .read_text())


TINY = {"nodes": 40, "steps": 16, "edges_per_snapshot": 100, "ranks": 1}


def test_tmgcn_bytes_by_hand():
    c = cfg("tmgcn")
    csr = 4 * 41 + 8 * 140                      # row pointers, col + w
    per_t = (csr + 8 * 40 * 2) + 2 * (csr + 8 * 40 * 6)
    assert counts.spmm_bytes(c, TINY) == 16 * per_t
    assert counts.ttm_bytes(c, TINY) == 2 * 4 * 4 * 16 * 40 * 6
    params = (2 * 6 + 6) + (6 * 6 + 6) + (6 * 2 + 2)
    assert counts.param_count(c) == params
    _, nbytes = counts.step_work(c, TINY)
    assert nbytes == 16 * (csr + 4 * 40 * 2 + 4 * 40) + 4 * 4 * params * 2


def test_tmgcn_flops_by_hand():
    c = cfg("tmgcn")
    nnz, n, t = 140, 40, 16
    band = 2 * (1 + 2 + 3 + 4 + 5 * 12) * n * 6   # sum of min(5, g)
    fwd = t * 2 * nnz * 2 + t * 2 * n * 2 * 6 + band \
        + t * 2 * nnz * 6 + t * 2 * n * 6 * 6 + band + t * 2 * n * 6 * 2
    bwd = 0 + t * 4 * n * 2 * 6 + band \
        + t * 2 * nnz * 6 + t * 4 * n * 6 * 6 + band + t * 4 * n * 6 * 2
    assert counts.step_work(c, TINY)[0] == pytest.approx(fwd + bwd, rel=1e-12)


def test_cdgcn_has_no_band_and_lstm_params():
    c = cfg("cdgcn")
    assert counts.ttm_bytes(c, TINY) == 0
    lstm = (2 + 6 + 6) * 24 + 24 + (6 + 6 + 6) * 24 + 24
    assert counts.param_count(c) == (2 * 6 + 6) + (6 * 6 + 6) + lstm + 14


@pytest.mark.parametrize("model", ["tmgcn", "cdgcn"])
def test_counts_are_a_ranks_share(model):
    c = cfg(model)
    four = dict(TINY, ranks=4)
    assert counts.spmm_bytes(c, four) == counts.spmm_bytes(c, TINY) / 4
    assert counts.ttm_bytes(c, four) == counts.ttm_bytes(c, TINY) / 4
    f1, _ = counts.step_work(c, TINY)
    f4, _ = counts.step_work(c, four)
    assert f4 == pytest.approx(f1 / 4, rel=1e-12)


def test_readers():
    c = cfg("tmgcn")
    prof = {"wall_s": 2.0, "steps": 2,
            "device": [("spmm_rows_edge_parallel<6>", 0.0, 4e5),
                       ("banded_ttm_window_kernel<5, 4>", 3e5, 5e5),
                       ("ncclDevKernel_AllToAll", 1.5e6, 1.6e6)]}
    ctx = {"cfg": c, "traffic": TINY, "chips": 1, "step_s": 1.0,
           "window_steps": 10, "profile": prof,
           "spans": {"train.csr_build": 0.25},
           "counters": {"partition.a2a_remote_bytes": 3e10},
           "kernel_seconds": lambda k: harness.kernel_seconds(
               prof["device"], k)}
    read = lambda name: harness.read_metric(name, ctx)   # noqa: E731
    assert read("idle_share") == pytest.approx(100 * (1 - 0.6 / 2.0))
    assert read("device_ops_per_step") == 1.5
    assert read("spmm_roofline") == pytest.approx(
        100 * counts.spmm_bytes(c, TINY) / counts.PEAK_BYTES / 0.2)
    assert read("ttm_roofline") == pytest.approx(
        100 * counts.ttm_bytes(c, TINY) / counts.PEAK_BYTES / 0.1)
    assert read("nccl_ms_per_step") == pytest.approx(50.0)
    assert read("csr_build_s") == 0.25
    assert read("a2a_remote_gb_per_step") == pytest.approx(3.0)
    flops, nbytes = counts.step_work(c, TINY)
    assert read("step_mfu") == pytest.approx(
        100 * max(flops / 67e12, nbytes / 3.35e12))
    ctx["counters"] = {}
    nccl_only = prof["device"][2:]
    ctx["profile"] = dict(prof, device=nccl_only)
    ctx["kernel_seconds"] = lambda k: harness.kernel_seconds(nccl_only, k)
    assert read("a2a_remote_gb_per_step") is None
    assert read("spmm_roofline") is None and read("ttm_roofline") is None
