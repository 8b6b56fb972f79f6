"""The rest of the port's ``eval/`` and the helpers no app calls, against
the JAX package where both compute the same thing.

- ``dense.view_selection.global_pair_assignment`` (TRW-S and ICM) and
  ``assignment_energy``: numpy in both packages, so the assignments and
  energies must be equal, on random score matrices of 4-40 images.
- ``utils.synth.plane_normal_of_view``: equal bits.
- ``utils.profiling.trace``: writes a Chrome trace.
- ``eval.refine_bench.build_case``: equal arrays; its CLI on the CPU.
- ``eval.cpu_anchor`` and ``eval.roofline --cpu``: their JSON lines.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from hcmvs_tpu.dense import view_selection as jvs
from hcmvs_tpu.utils import synth as jsynth

from hcmvs_tpu_torch.dense import view_selection as tvs
from hcmvs_tpu_torch.utils import synth as tsynth

torch.set_num_threads(1)


def _scores(n, seed):
    """A covisibility-like score matrix: symmetric, zero diagonal, a
    share of zero pairs."""
    rng = np.random.default_rng(seed)
    s = rng.gamma(2.0, 1.0, (n, n)) * (rng.random((n, n)) > 0.3)
    s = np.triu(s, 1)
    return s + s.T


CASES = [(4, 0), (6, 1), (9, 2), (13, 3), (20, 4), (27, 5), (40, 6)]


@pytest.mark.parametrize("solver", ["trws", "icm"])
@pytest.mark.parametrize("n,seed", CASES)
def test_global_pair_assignment_equals_jax(solver, n, seed):
    score = _scores(n, seed)
    a_t = tvs.global_pair_assignment(score, solver=solver)
    a_j = jvs.global_pair_assignment(score, solver=solver)
    assert np.array_equal(a_t, a_j)
    assert tvs.assignment_energy(score, a_t) == jvs.assignment_energy(
        score, a_j)
    # a random assignment's energy too
    rand = np.random.default_rng(seed + 100).integers(-1, n, n)
    assert tvs.assignment_energy(score, rand) == jvs.assignment_energy(
        score, rand)


def test_trws_labels_and_mrf_equal_jax():
    score = _scores(12, 9)
    t = tvs._pair_mrf(score, 8, 0.3)
    j = jvs._pair_mrf(score, 8, 0.3)
    for a, b in zip(t, j):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(tvs._trws_labels(*t[:4], t[4], 30),
                          jvs._trws_labels(*j[:4], j[4], 30))


def test_plane_normal_of_view_equals_jax():
    for seed, n in ((0, 3), (1, 5), (2, 8)):
        js = jsynth.make_plane_scene(np.random.default_rng(seed), h=32,
                                     w=48, n_views=n)
        ts = tsynth.make_plane_scene(np.random.default_rng(seed), h=32,
                                     w=48, n_views=n)
        for v in range(n):
            a = np.asarray(jsynth.plane_normal_of_view(js, v))
            b = tsynth.plane_normal_of_view(ts, v)
            assert b.dtype == np.float32 and np.array_equal(a, b)


def test_texture_params_take_a_wave_count():
    for n_waves in (5, 24):
        a = jsynth._texture_params(np.random.default_rng(4), n_waves)
        b = tsynth._texture_params(np.random.default_rng(4), n_waves)
        for x, y in zip(a, b):
            assert x.shape[0] == n_waves and np.array_equal(x, y)


def test_trace_writes_a_chrome_trace(tmp_path):
    from hcmvs_tpu_torch.utils.profiling import trace
    with trace(str(tmp_path / "tr")) as d:
        torch.ones(64).cumsum(0)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        assert json.load(f)["traceEvents"]


def test_refine_bench_build_case_equals_jax():
    from hcmvs_tpu.eval import refine_bench as jrb
    from hcmvs_tpu_torch.eval import refine_bench as trb
    kw = dict(h=48, w=64, n_views=3, grid=16)
    t = trb.build_case(**kw)
    j = jrb.build_case(**kw)
    for a, b in zip(t[1:], j[1:]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(t[0].depth_gt, j[0].depth_gt)


def _json_lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [json.loads(x) for x in buf.getvalue().splitlines()]


def test_refine_bench_cli_on_the_cpu():
    from hcmvs_tpu_torch.eval import refine_bench
    (out,) = _json_lines(refine_bench.main, ["--cpu", "--h", "96", "--w",
                                             "128", "--views", "3",
                                             "--iters", "1"])
    assert out["metric"] == "mesh_refine_grad_iteration"
    assert out["size"] == "128x96" and out["pairs"] == 4
    assert out["grad_s"] > 0 and out["device"] == "cpu"


def test_cpu_anchor_prints_its_line():
    from hcmvs_tpu_torch.eval import cpu_anchor
    (out,) = _json_lines(cpu_anchor.main, ["--sizes", "48x64", "--rounds",
                                           "1"])
    assert {"metric", "h", "w", "value", "round_s", "n_threads",
            "unit"} <= set(out)
    assert out["metric"] == "cpu_views_per_s" and out["value"] > 0


def test_roofline_cpu_prints_its_report():
    from hcmvs_tpu_torch.eval import roofline
    (out,) = _json_lines(roofline.main, ["--cpu", "--h", "48", "--w", "64",
                                         "--rounds", "1"])
    assert out["clock"] == "host" and out["platform"] == "cpu"
    for stage in ("table_build", "photometric", "geometric"):
        assert out[stage]["seconds"] > 0 and out[stage]["share"] is None
        assert out[stage]["bound_by"] in ("bytes", "operations")
    assert out["table_build"]["entries"] >= 4 * 3 * 128 * 48 * 64
    assert out["round"]["views_per_s"] > 0


def test_chip_smoke_reads_the_ceilings_from_roofline():
    from hcmvs_tpu_torch.eval import roofline
    src = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")).read()
    assert "HBM_BYTES_PER_S = " not in src and "F32_OPS_PER_S = " not in src
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.F32_OPS_PER_S == 67e12
