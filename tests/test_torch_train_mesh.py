"""The train launcher over a mesh: `--env dp_tp --data 2 --model 2` on the
CPU spawns 4 gloo ranks itself (one world, this file's only one), rank 0
prints the summary, and the losses equal the unsharded launcher's run of
the same seed at rtol 1e-5 (the sharded reductions reassociate)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

ARGS = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "8",
        "--seq", "32", "--log-every", "1", "--compress-grads"]


def test_train_launcher_on_a_2x2_mesh(capfd):
    from repro_torch.launch.train import train
    mesh = train(ARGS + ["--env", "dp_tp", "--data", "2", "--model", "2"])
    out = capfd.readouterr().out
    assert "trained 3 steps on a 2x2 dp_tp mesh (4 ranks, cpu)" in out
    assert out.count("step ") == 3        # rank 0 logs, the others do not
    assert mesh["env"] == "dp_tp" and mesh["mesh"] == [2, 2]
    plain = train(ARGS)
    np.testing.assert_allclose(mesh["losses"], plain["losses"], rtol=1e-5)
    assert mesh["entropy_floor"] == plain["entropy_floor"]
