"""The port's checkpoint manager: an async save holds the values of the
moment it was called, though the next step writes the leaves in place
(the optimizer's ``add_``/``mul_``), for CPU tensors too; the ``extra``
blob commits with the leaves and reads back through ``load_extra``; numpy
leaves round-trip as numpy arrays."""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager

# large enough that the background writer is still on the first leaves
# while the caller overwrites the rest
N_LEAVES, LEAF = 8, 1 << 21


def _state():
    return {"w": [torch.zeros(LEAF) for _ in range(N_LEAVES)],
            "h": torch.zeros(LEAF, dtype=torch.bfloat16), "count": 0}


@pytest.mark.parametrize("rounds", [1, 3])
def test_async_save_is_not_torn_by_in_place_updates(tmp_path, rounds):
    mgr = CheckpointManager(str(tmp_path), keep=rounds, async_save=True)
    state = _state()
    for step in range(rounds):
        mgr.save(step, state)            # returns before the write ends
        for t in state["w"]:
            t.add_(1.0)                  # the next step, in place
        state["h"].add_(1.0)
    mgr.wait()
    for step in range(rounds):
        got, at = mgr.restore(_state(), step=step)
        assert at == step
        for i, t in enumerate(got["w"]):
            assert float(t.sum()) == step * LEAF, (step, i)
        assert got["h"].dtype == torch.bfloat16
        assert float(got["h"].float().sum()) == step * LEAF


def test_extra_round_trips_with_the_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    extra = {"queue": [3, 1], "slots": [None, 7], "next_rid": 9}
    pos = np.array([4, 0, 2], np.int64)
    mgr.save(5, {"x": torch.arange(4.0), "pos": pos}, extra=extra)
    pos[:] = -1                           # the saved copy is unaffected
    mgr.save(6, {"x": torch.ones(4), "pos": pos})
    assert mgr.load_extra(5) == extra
    assert mgr.load_extra() is None       # step 6 carries none
    got, _ = mgr.restore({"x": torch.zeros(4),
                          "pos": np.zeros(3, np.int64)}, step=5)
    assert isinstance(got["pos"], np.ndarray)
    np.testing.assert_array_equal(got["pos"], [4, 0, 2])
    torch.testing.assert_close(got["x"], torch.arange(4.0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).load_extra()


def test_save_sharded_passes_extra_to_the_writer(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save_sharded(2, {"x": torch.ones(2)}, lambda s: s, writer=True,
                     extra={"k": 1})
    assert mgr.load_extra(2) == {"k": 1}
    other = CheckpointManager(str(tmp_path / "r1"), async_save=False)
    other.save_sharded(2, {"x": torch.ones(2)}, lambda s: s, writer=False,
                       extra={"k": 1})
    assert other.latest_step() is None
