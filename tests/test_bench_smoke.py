"""End-to-end smoke of EVERY bench.py stage at toy sizes (CPU).

A stage that cannot build its circuit once crashed a full benchmark run
before it printed anything.  This test runs the full `main()` stage
plumbing (incremental JSON emission, budget handling, per-stage error
isolation) plus each stage function directly, so such a stage fails here
in seconds, not on the accelerator.
"""

import io
import json
import sys

import pytest

import bench


def _toy_args(**over):
    # nodes >= 128: _branch_circuit's VCCS probes mesh node n3_3, which
    # needs the 25-row mesh to be at least 4 columns wide.
    argv = [
        "--nodes", "128", "--batch", "32", "--general-batch", "8",
        "--reps", "1", "--midsize-nodes", "300", "--midsize-batch", "4",
        "--sparse-nodes", "96", "--sparse40k-nodes", "96", "--sparse-h", "8",
        "--ebig-nodes", "96", "--opmodel-stages", "3",
        "--vccs-border-nodes", "96", "--vccs-border-rows", "8",
        "--mc-samples", "32", "--mc-sub-samples", "16",
        "--grid", "16", "--budget", "600",
    ]
    for k, v in over.items():
        argv += [k, str(v)]
    return argv


def _run_main(argv):
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        rc = bench.main(argv)
    finally:
        sys.stdout = old
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    assert rc == 0 and lines
    return [json.loads(ln) for ln in lines]


def test_main_runs_every_stage_at_toy_size():
    # Deliberately NOT marked slow (~90 s): every stage function must build
    # its circuits and run end-to-end through main().
    payloads = _run_main(_toy_args())
    # Incremental emission: one line after the headline, one per stage,
    # plus the final re-print — the *first* line must already be parseable
    # (the driver-timeout insurance).
    assert len(payloads) >= 3
    first, final = payloads[0], payloads[-1]
    for p in (first, final):
        assert p["metric"] == "batched_solves_per_sec_128_nodes"
        assert p["value"] > 0 and p["unit"] == "solves/s"
    # Every stage ran: no skip, no isolated errors, and each stage's
    # signature fields are present in the final payload.
    assert "skipped_stages" not in final
    assert "stage_errors" not in final, final.get("stage_errors")
    for key in (
        "batched_sustained_solves_per_sec",
        "batched_raw_sustained_solves_per_sec",
        "batched_raw_rel_err_vs_f64",
        "sparse40k_cold_s", "sparse40k_rel_residual_f64",
        "midsize_rel_err_vs_f64",
        "sparse_cold_s", "sparse_grad_warm_s",
        "sparse_ebig_rel_residual_f64", "sparse_ebig_e_sources",
        "opmodel_rel_residual_f64", "opmodel_unknowns",
        "vccs_border_rel_residual_f64", "vccs_border_rows",
        "general_rel_err_vs_f64", "branch_rel_err_vs_f64",
        "mc_solves_per_sec", "mc_mesh_solves_per_sec",
        "mc_branch_solves_per_sec",
        "grad_solves_per_sec",
        "grid_cg_iters",
    ):
        assert key in final, f"missing {key}"
    expected_stages = {"ladder", "sparse40k", "midsize", "sparse", "ebig",
                       "opmodel", "vccs_border", "general", "mc", "mc_mesh",
                       "mc_branch", "grad", "grid"}
    assert expected_stages <= set(final["stage_times_s"])
    # The OPMODEL chain is the ill-conditioned proof point: f64 path,
    # residual must be at the f64 floor even at toy size.
    assert final["opmodel_rel_residual_f64"] <= 1e-9


def test_budget_zero_skips_everything_after_headline_loudly():
    payloads = _run_main(_toy_args(**{"--budget": 0}))
    final = payloads[-1]
    assert final["value"] > 0  # headline still measured
    skipped = set(final["skipped_stages"])
    assert {"sparse40k", "midsize", "opmodel", "grid"} <= skipped
    assert "stage_errors" not in final


def test_stage_crash_is_isolated(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("injected stage failure")

    monkeypatch.setattr(bench, "bench_monte_carlo", boom)
    payloads = _run_main(_toy_args() + [
        "--skip-sparse", "--skip-grid", "--skip-general", "--skip-grad"])
    final = payloads[-1]
    # The crash is recorded, later stages unaffected, artifact parseable.
    assert any("injected stage failure" in v
               for v in final["stage_errors"].values())
    assert final["value"] > 0


def test_opmodel_row_layout_builds():
    # Direct guard on the round-4 crash: the generated OPMODEL rows must
    # satisfy the 7-field [name, OPMODEL, rf, out, gnd, pos, neg] schema.
    out = bench.bench_opmodel_chain(n_stages=2)
    assert out["opmodel_unknowns"] > 0
    assert out["opmodel_rel_residual_f64"] <= 1e-9


def test_roofline_uses_device_kind_table():
    # H100 shares against the data-sheet peaks (67 TFLOP/s f32, 3.35 TB/s).
    out = bench._roofline((67e9, 3.35e9), 100.0, "NVIDIA H100 80GB HBM3")
    assert out["tflops"] == pytest.approx(6.7)
    assert out["pct_flops_peak"] == pytest.approx(10.0)
    assert out["hbm_gbps"] == pytest.approx(335.0)
    assert out["pct_hbm_peak"] == pytest.approx(10.0)
    assert out["bound"] == "latency/pipeline"


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_roofline_unknown_device_gets_no_fields(kind):
    # No default peaks: a device missing from the table reports nothing.
    assert bench._roofline((1e9, 1e9), 100.0, kind) == {}


def test_payload_names_its_device():
    final = _run_main(_toy_args() + [
        "--skip-sparse", "--skip-grid", "--skip-general", "--skip-grad",
        "--skip-mc", "--midsize-nodes", "0"])[-1]
    assert final["backend"] == "cpu" and final["device_kind"] == "cpu"
    assert final["device_count"] >= 1
    assert not any(k.endswith("pct_flops_peak") for k in final)
