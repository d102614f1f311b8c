"""The port's MultiSlam over two real processes (tests/test_multiprocess.py's
check, on torch.distributed): two spawned gloo ranks (FileStore, each
joined with its own timeout) on a {"seq": 2, "lm": 1} mesh, one sequence
each, against a single-process MultiSlam of the same two sequences: the
same keyframes and, to 1e-5, the same last poses (the JAX package allows
5e-2 between its layouts; the port's ranks run the same CPU arithmetic).
Both ranks write their rows into one torch.distributed.checkpoint
directory and their row as npz (utils/checkpoint.py): read back here,
each holds the rank's state exactly."""

import numpy as np
import torch

from racing_slam_tpu_torch.parallel.multi_seq import MultiSlam, batched_state
from racing_slam_tpu_torch.slam.state import state_row
from racing_slam_tpu_torch.utils.checkpoint import _named_leaves, load_state, load_state_sharded
from racing_slam_tpu_torch.utils.video import ArraySource
from tests.torch_mp_worker import multi_worker, run_ranks
from torch_multi_world import tiny_cfg, tiny_world

torch.set_num_threads(2)


def test_two_process_run_matches_single(tmp_path):
    codes = run_ranks(multi_worker, 2, str(tmp_path), timeout_s=300.0)
    assert codes == [0, 0], codes

    cam, seqs = tiny_world()
    ms = MultiSlam(cam, [ArraySource(s.frames) for s in seqs], None, tiny_cfg(), device="cpu")
    assert ms.initialize()
    assert ms.run_batched(max_frames=6, batch=3) == 6
    want = ms.states_per_sequence()

    got = [load_state(tmp_path / f"state{g}.npz", device="cpu") for g in range(2)]
    for g in range(2):
        assert torch.equal(got[g].kfs.valid, want[g].kfs.valid)
        assert int(got[g].num_kf) == int(want[g].num_kf)
        np.testing.assert_allclose(got[g].last_t.numpy(), want[g].last_t.numpy(), atol=1e-5)
        np.testing.assert_allclose(got[g].last_rvec.numpy(), want[g].last_rvec.numpy(),
                                   atol=1e-5)

    one = want[0]
    template = batched_state(2, F=4, Pcap=256, O=4, K=one.kfs.kp_xy.shape[1], D=128,
                             A=one.arch_rvec.shape[0], device="cpu")
    rows = load_state_sharded(tmp_path / "ckpt", template)
    for g in range(2):
        for a, b in zip(_named_leaves(state_row(rows, g)).values(),
                        _named_leaves(got[g]).values()):
            assert torch.equal(a, b)
