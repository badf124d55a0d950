"""repro_torch's data pipeline and checkpoint manager against the JAX
reference, on the CPU.

* ``SyntheticLM``: every array of a batch byte-equal to the reference's
  (tokens, whisper's audio frames, qwen2-vl's patch embeddings) at several
  steps and host splits: the same numpy draws in the same order.
* ``CheckpointManager``: the roundtrip, retention and atomicity cases of
  tests/test_runtime.py on the port, a background write's error surfacing
  on the next ``wait()``, and checkpoints crossing packages: one the port
  writes restores in the reference's manager and the reverse, key for
  key, bf16 bit-exact.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.ckpt import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.ckpt import CheckpointManager, latest_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402


# -- data pipeline -----------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-14b", "whisper-base", "qwen2-vl-7b"])
@pytest.mark.parametrize("host_index,host_count", [(0, 1), (0, 2), (1, 2)])
def test_synthetic_batches_byte_equal(arch, host_index, host_count):
    kw = dict(host_index=host_index, host_count=host_count)
    dk = dict(seed=3, enc_frames=40, vision_tokens=12)
    want = JSynthetic(jget_config(arch, reduced=True),
                      JShape("t", 24, 4, "train"), JData(**dk), **kw)
    got = SyntheticLM(get_config(arch, reduced=True),
                      ShapeConfig("t", 24, 4, "train"), DataConfig(**dk), **kw)
    assert got.local_batch == want.local_batch
    for step in (0, 1, 7, 1000):
        a, b = got.batch_at(step), want.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (arch, step, k)
    it = iter(got)
    assert next(it)["tokens"].tobytes() == want.batch_at(0)["tokens"].tobytes()


def test_synthetic_host_split_refused():
    with pytest.raises(ValueError):
        SyntheticLM(get_config("qwen3-14b", reduced=True),
                    ShapeConfig("t", 8, 5, "train"), host_count=2)


# -- checkpoint manager --------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": [torch.ones(()), torch.zeros((4,), dtype=torch.int32)]}


def test_ckpt_roundtrip_and_retention(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3):
        ck.save(s, tree, extra={"tag": s}, blocking=True)
    assert latest_step(str(tmp_path)) == 3
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [2, 3]
    step, got, extra = ck.restore(like=tree)
    assert step == 3 and extra == {"tag": 3}
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"], tree["a"])
    assert got["b"][1].dtype == torch.int32 and isinstance(got["b"], list)


def test_ckpt_atomicity(tmp_path):
    """A lingering .tmp dir is never picked up as a checkpoint."""
    ck = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(tmp_path, "step_9.tmp"))
    ck.save(1, {"x": torch.ones((2,))}, blocking=True)
    assert latest_step(str(tmp_path)) == 1


def test_ckpt_async_error_surfaces_on_wait(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, {"x": torch.ones((2,))})
    ck.wait()
    assert latest_step(str(tmp_path)) == 1
    # a file where the temporary directory must go makes the write fail
    open(os.path.join(tmp_path, "step_2.tmp"), "w").close()
    ck.save(2, {"x": torch.ones((2,))})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.wait()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()
    with pytest.raises(ValueError, match="pspecs and mesh together"):
        ck.restore(like={"x": torch.ones((2,))}, mesh=object())


def test_ckpt_async_save_snapshots_cpu_leaves(tmp_path, monkeypatch):
    """``save`` copies every leaf before it returns: a CPU leaf updated in
    place while the background write is held back is restored as it was
    at the save (the trainer's next step updates its state in place)."""
    import threading
    from repro_torch.ckpt import manager
    go, savez = threading.Event(), np.savez

    def held(*a, **kw):
        go.wait(10)
        return savez(*a, **kw)

    monkeypatch.setattr(manager.np, "savez", held)
    tree = _tree()
    old = {k: v.clone() for k, v in pytree.flatten_with_paths(tree).items()}
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, tree)
    tree["a"].add_(1)
    tree["b"][0].copy_(torch.tensor(5.0))
    tree["b"][1].fill_(7)
    go.set()
    ck.wait()
    _, got, _ = ck.restore(like=tree)
    for k, v in pytree.flatten_with_paths(got).items():
        assert v.dtype == old[k].dtype and torch.equal(v, old[k]), k


@pytest.fixture(scope="module")
def states():
    """The reference's TrainState of reduced bf16 qwen3-14b with
    compression residuals (numpy leaves), and the port's copy of it."""
    shape = JShape("t", 16, 2, "train")
    jt = JTrainer(jget_config("qwen3-14b", reduced=True), shape,
                  JTrain(grad_compression=True))
    jstate = jax.tree.map(np.asarray, jt.init_state(3))
    return jstate, bridge.train_state_from_numpy(jstate, device="cpu")


def _template():
    return Trainer(get_config("qwen3-14b", reduced=True),
                   ShapeConfig("t", 16, 2, "train"),
                   TrainConfig(grad_compression=True),
                   device="cpu")._restore_template()


def _assert_bits_equal(torch_leaf, np_leaf):
    a = torch_leaf
    if a.dtype == torch.bfloat16:
        assert np_leaf.dtype == ml_dtypes.bfloat16
        assert np.array_equal(a.view(torch.int16).numpy(),
                              np_leaf.view(np.int16))
    else:
        assert np.array_equal(a.numpy(), np_leaf)
        assert a.numpy().dtype == np_leaf.dtype


def test_ckpt_port_to_reference(tmp_path, states):
    """A TrainState the port saves restores in the reference's manager,
    key for key, bf16 bit-exact."""
    jstate, tstate = states
    CheckpointManager(str(tmp_path)).save(5, tstate, extra={"k": 5},
                                          blocking=True)
    with open(tmp_path / "step_5" / "manifest.json") as f:
        meta = json.load(f)
    assert ".params/embed/table" in meta["keys"] and ".opt/.step" in meta[
        "keys"] and ".data_step" in meta["keys"]
    assert meta["dtypes"][".params/embed/table"] == "bfloat16"
    step, got, extra = JCkpt(str(tmp_path)).restore(like=jstate)
    assert step == 5 and extra == {"k": 5}
    from repro.ckpt.manager import _flatten_with_paths
    want = _flatten_with_paths(jstate)
    got = _flatten_with_paths(got)
    mine = pytree.flatten_with_paths(tstate)
    assert set(got) == set(want) == set(mine)
    for k, v in mine.items():
        _assert_bits_equal(v, np.asarray(got[k]))


def test_ckpt_reference_to_port(tmp_path, states):
    """A reference checkpoint restores into the port's TrainState
    (structure from a meta-device template), key for key, bf16 bit-exact."""
    jstate, tstate = states
    JCkpt(str(tmp_path)).save(7, jax.tree.map(jnp.asarray, jstate),
                              extra={"k": 7}, blocking=True)
    step, got, extra = CheckpointManager(str(tmp_path)).restore(
        like=_template(), device="cpu")
    assert step == 7 and extra == {"k": 7}
    assert type(got).__name__ == "TrainState"
    assert type(got.opt).__name__ == "AdamWState"
    mine = pytree.flatten_with_paths(got)
    want = pytree.flatten_with_paths(tstate)
    assert set(mine) == set(want)
    for k, v in mine.items():
        assert v.dtype == want[k].dtype and v.device.type == "cpu"
        assert torch.equal(v, want[k]), k
    flat = CheckpointManager(str(tmp_path)).restore()[1]
    assert flat[".params/embed/table"].dtype == torch.bfloat16
