"""The quality ladder's CLI: the port's ``hcmvs_tpu_torch.eval.
quality_ladder`` against the JAX package's at 48x64 on the CPU.

Both print one JSON line per external iteration and a final one after the
confidence threshold, on the same ridge scene (seed 0, spacing 0.25, 5
views, the first three others as neighbours, d_min / d_max from the
ground truth).  The JAX side forces the tables and the rect engine
(``--exact-backend volume --geo-backend rect``, ``volume_build="rect"``),
which the port's defaults take.  Tolerance: view 0's accuracies within
0.03 and the kept share within 0.03 (the two packages' random streams
differ), the lines' keys and schedule equal.
"""

import contextlib
import io
import json

import jax
import pytest
import torch

from hcmvs_tpu.eval import quality_ladder as jladder

from hcmvs_tpu_torch.eval import quality_ladder as tladder

torch.set_num_threads(1)
ARGS = ["--h", "48", "--w", "64", "--fx", "60", "--iters", "1", "--ext",
        "2"]


def _lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [json.loads(x) for x in buf.getvalue().splitlines()
            if x.startswith("{")]


def test_ladder_lines_match_jax(monkeypatch):
    import sys
    # the JAX CLI sets the platform and a compilation cache directory:
    # keep both out of this test process
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda k, v: None if (
        "cache" in k or k == "jax_platforms") else update(k, v))
    monkeypatch.setattr(sys, "argv", ["quality_ladder", *ARGS, "--cpu",
                                      "--exact-backend", "volume",
                                      "--geo-backend", "rect", "--cfg",
                                      '{"volume_build": "rect"}'])
    ref = _lines(lambda _: jladder.main(), None)
    out = _lines(tladder.main, ARGS + ["--device", "cpu"])
    assert [sorted(x) for x in out] == [sorted(x) for x in ref]
    assert [x.get("it_ext") for x in out] == [x.get("it_ext") for x in ref]
    assert [x.get("phase") for x in out] == [x.get("phase") for x in ref]
    fin_o, fin_r = out[-1], ref[-1]
    assert fin_o["final"] and fin_o["size"] == fin_r["size"] == "64x48"
    for key in ("acc2pct", "acc1pct", "valid"):
        assert abs(fin_o[key] - fin_r[key]) <= 0.03, (key, fin_o, fin_r)
    assert fin_o["acc2pct"] > 0.3     # the random init scores ~0.05


def test_ladder_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tladder.main(ARGS)
