"""`python -m mvs_tpu_torch.cli profile` on the CPU (counterpart of
mvs_tpu.cli.profile): the forward of __graft_entry__.entry()'s CasMVSNet
(8/8/8 hypotheses, 64x64, 3 views, batch 1) traced under torch.profiler
writes a Chrome trace and prints the ms/step line and the top operators;
--train traces one CasMVSNet train step; the example batch is
__graft_entry__._example_batch's."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

from mvs_tpu_torch.cli import profile

REPO = Path(__file__).resolve().parents[1]


def test_profile_command_writes_a_trace(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "mvs_tpu_torch.cli", "profile", "--device",
         "cpu", "--steps", "1", "--warmup", "1", "--logdir",
         str(tmp_path / "prof")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^1 steps traced to .*prof; [0-9.]+ ms/step "
                     r"\([0-9.]+ depth-maps/s\)$", out.stdout,
                     re.M), out.stdout
    assert "top operators by self CPU ms:" in out.stdout
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])


def test_profile_train_step(tmp_path, capsys):
    result = profile.main(["--device", "cpu", "--train", "--steps", "1",
                           "--warmup", "0", "--logdir", str(tmp_path)])
    assert result["ms_per_step"] > 0 and Path(result["trace"]).exists()
    assert "1 train steps traced" in capsys.readouterr().out
    assert any("convolution_backward" in line for line in result["table"])


def test_example_batch_is_the_graft_entry_batch():
    import __graft_entry__ as ge

    want = ge._example_batch(batch_size=1)
    got = profile.example_batch("cpu")
    np.testing.assert_array_equal(got["imgs"].numpy(), np.asarray(
        want["imgs"]))
    np.testing.assert_allclose(got["depth_values"].numpy(),
                               np.asarray(want["depth_values"]), rtol=1e-6)
    for key in ("proj_matrices", "depth_gt", "mask"):
        for stage, w in want[key].items():
            np.testing.assert_allclose(got[key][stage].numpy(),
                                       np.asarray(w), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{key}/{stage}")
