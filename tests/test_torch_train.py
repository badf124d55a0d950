"""repro_torch's training stack against the JAX reference, on the CPU.

Reduced configs, float32 unless stated; the reference's parameters (and
whole ``TrainState``) reach the port through ``bridge``, inputs come from
seeded numpy generators or the shared ``SyntheticLM``.  Tolerances:

* ``loss_fn``: the loss within 1e-5 relative, every gradient leaf within
  1e-4 of that leaf's largest magnitude, the MoE metrics within 1e-6
  (the same math; XLA and PyTorch sum in other orders).  ``loss_chunk`` 4
  does not divide S - 1 = 15, so the zero-padded last chunk is exercised.
* activation checkpointing changes no bit of the gradients.
* a chunked loss equals the unchunked one within 1e-6 relative (chunk
  sums add in another order).
* ``Trainer`` histories (loss, grad norm, lr) against the reference's
  single-device ``Trainer`` from the same state: 1e-4 relative, plain and
  with int8 gradient compression; deepseek's divergence telemetry within
  1e-5 and the controller's decisions equal.
* ``micro_steps=2`` against 1: 5e-4 (tests/test_runtime.py); the resume
  after injected failures: 1e-6 (tests/test_runtime.py), bf16 as there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import AmoebaConfig as JAmoeba  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.core.controller import AmoebaController as JController  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch import bridge, pytree  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.base import (AmoebaConfig, ShapeConfig,  # noqa: E402
                                      TrainConfig)
from repro_torch.core.controller import AmoebaController  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

B, S, CHUNK, FRAMES = 2, 16, 4, 64
SHAPE = ("tiny", 32, 4, "train")


def _setup(arch, dtype="float32"):
    jc = jget_config(arch, reduced=True).replace(dtype=dtype)
    tc = get_config(arch, reduced=True).replace(dtype=dtype)
    jp, _ = JT.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _batch(cfg, seed=1):
    """tokens, plus whisper's audio frames or qwen2-vl's patches."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.encoder_layers:
        b["audio_embeds"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    if cfg.vision_stub:
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.max_vision_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _grads(tp, tb, tc, rt):
    """(loss, metrics, {path: grad}) through the trainer's autograd."""
    tr = Trainer(tc, ShapeConfig("t", S, B, "train"), device="cpu", rt=rt)
    loss, metrics, grads = tr.loss_and_grads(tp, tb)
    return loss, metrics, pytree.flatten_with_paths(grads)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    jc, tc, jp, tp = _setup(arch)
    jb, tb = _batch(jc)
    jrt = JT.Runtime(production=False, loss_chunk=CHUNK)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jc, jrt), has_aux=True)(jp)
    tl, tm, tg = _grads(tp, tb, tc, T.Runtime(loss_chunk=CHUNK))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert sorted(tm) == sorted(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(want) == len(tg)
    for path, g in want:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        g = np.asarray(g)
        np.testing.assert_allclose(tg[key].numpy(), g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-30),
                                   err_msg=key)


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-moe-16b",
                                  "whisper-base", "recurrentgemma-9b"])
def test_remat_changes_no_gradient_bit(arch):
    _, tc, _, tp = _setup(arch)
    _, tb = _batch(tc)
    on = _grads(tp, tb, tc, T.Runtime(remat=True, loss_chunk=CHUNK))
    off = _grads(tp, tb, tc, T.Runtime(remat=False, loss_chunk=CHUNK))
    assert torch.equal(on[0], off[0])
    for k, g in on[2].items():
        assert torch.equal(g, off[2][k]), k
    with torch.no_grad():           # serving: no checkpoint, same loss
        loss, _ = T.loss_fn(tp, tb, tc, T.Runtime(loss_chunk=CHUNK))
    assert torch.equal(loss, on[0])


@pytest.mark.parametrize("arch", ["qwen3-14b", "whisper-base"])
def test_remat_only_where_a_gradient_is_needed(arch, monkeypatch):
    """Serving leaves grad mode on with parameters that need no gradient:
    ``logits_fn`` and ``loss_fn`` then checkpoint nothing; the trainer's
    autograd checkpoints every block (the encoder's too) and loss chunk."""
    _, tc, _, tp = _setup(arch)
    _, tb = _batch(tc)
    calls = []
    real = T.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(T, "checkpoint", counted)
    assert torch.is_grad_enabled()
    T.logits_fn(tp, tb, tc)
    T.loss_fn(tp, tb, tc, T.Runtime(loss_chunk=CHUNK))
    assert calls == []
    _grads(tp, tb, tc, T.Runtime(loss_chunk=CHUNK))
    chunks = -(-(S - 1) // CHUNK)
    assert len(calls) == tc.num_layers + tc.encoder_layers + chunks


@pytest.mark.parametrize("chunk", [1, 4, 7, 15, 512])
def test_loss_chunk_not_dividing_equals_unchunked(chunk):
    _, tc, _, tp = _setup("qwen3-14b")
    _, tb = _batch(tc)
    with torch.no_grad():
        got, _ = T.loss_fn(tp, tb, tc, T.Runtime(loss_chunk=chunk))
        logits, _ = T.logits_fn(tp, tb, tc)
    from repro_torch.models.layers import next_token_loss
    want = next_token_loss(logits, tb["tokens"])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- the trainer ----------------------------------------------------------------

def _histories(jhist, thist, rtol=1e-4):
    assert [m.step for m in thist] == [m.step for m in jhist]
    for a, b in zip(thist, jhist):
        for f in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=rtol, err_msg=f"{f} {a.step}")


def _pair(arch, steps, controllers=(None, None), **tkw):
    """The reference's and the port's Trainer, ``steps`` steps from the
    reference's initial state: -> (ref out, port out)."""
    jc = jget_config(arch, reduced=True).replace(dtype="float32")
    tc = get_config(arch, reduced=True).replace(dtype="float32")
    kw = dict(total_steps=steps, warmup_steps=1, learning_rate=1e-3, **tkw)
    jt = JTrainer(jc, JShape(*SHAPE), JTrain(**kw), controller=controllers[0])
    jstate = jax.tree.map(np.asarray, jt.init_state(0))
    tt = Trainer(tc, ShapeConfig(*SHAPE), TrainConfig(**kw),
                 controller=controllers[1], device="cpu")
    tstate = bridge.train_state_from_numpy(jstate, device="cpu")
    jout = jt.train(steps, state=jax.tree.map(jnp.asarray, jstate))
    return jout, tt.train(steps, state=tstate)


@pytest.fixture(scope="module")
def qwen_runs():
    return {c: _pair("qwen3-14b", 3, grad_compression=c)
            for c in (False, True)}


@pytest.mark.parametrize("compression", [False, True])
def test_trainer_history_matches_reference(qwen_runs, compression):
    jout, tout = qwen_runs[compression]
    _histories(jout["history"], tout["history"])
    assert (tout["state"].residuals is not None) == compression
    assert int(tout["state"].data_step) == int(jout["state"].data_step) == 3
    assert int(tout["state"].opt.step) == 3
    if compression:
        # the residuals hold what the int8 wire format failed to carry;
        # a gradient an ulp apart can round to the next code, so they are
        # compared by shape and dtype, not value
        jr = jax.tree.map(np.asarray, jout["state"].residuals)
        tr = pytree.flatten_with_paths(tout["state"].residuals)
        from repro.ckpt.manager import _flatten_with_paths
        for key, r in _flatten_with_paths(jr).items():
            assert tr[key].shape == r.shape
            assert tr[key].dtype == torch.float32
            assert bool(torch.isfinite(tr[key]).all())


def test_deepseek_divergence_telemetry_matches_reference():
    """tests/test_runtime.py::test_moe_divergence_telemetry on both
    packages from one state: each step's divergence (from ``expert_load``)
    and the controller's split decisions equal the reference's."""
    kw = dict(min_phase_steps=1)
    jctl, tctl = JController(JAmoeba(**kw)), AmoebaController(
        AmoebaConfig(**kw))
    jout, tout = _pair("deepseek-moe-16b", 4, controllers=(jctl, tctl))
    _histories(jout["history"], tout["history"])
    assert all(m.divergence > 0 for m in tout["history"])
    for a, b in zip(tout["history"], jout["history"]):
        assert abs(a.divergence - b.divergence) < 1e-5, (a.step, a, b)
    assert len(tctl.split_state.history) == 4
    assert [h[1] for h in tctl.split_state.history] == \
        [h[1] for h in jctl.split_state.history]


def _port_trainer(dtype="bfloat16", **tkw):
    cfg = get_config("qwen3-14b", reduced=True).replace(dtype=dtype)
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, learning_rate=1e-3,
                       checkpoint_every=4, **tkw)
    return Trainer(cfg, ShapeConfig(*SHAPE), tcfg, device="cpu")


def test_micro_steps_match_full_batch():
    h1 = _port_trainer("float32", micro_steps=1).train(3)["history"]
    h2 = _port_trainer("float32", micro_steps=2).train(3)["history"]
    for a, b in zip(h1, h2):
        assert abs(a.loss - b.loss) < 5e-4, (a.step, a.loss, b.loss)


def test_failure_resume_is_exact(tmp_path):
    base = _port_trainer().train(10)
    losses = [m.loss for m in base["history"]]
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    ck = CheckpointManager(str(tmp_path), keep=2)
    fails = {5, 8}

    def inject(k):
        if k in fails:
            fails.discard(k)
            return True
        return False

    out = _port_trainer().train(10, ckpt=ck, failure_injector=inject)
    assert out["resumes"] == 2
    got = [(m.step, m.loss) for m in out["history"]]
    # step 5 fails and resumes from step_4; step 8 from step_8
    assert [s for s, _ in got] == [0, 1, 2, 3, 4, 4, 5, 6, 7, 8, 9]
    for s, loss in got:
        assert abs(loss - losses[s]) < 1e-6, (s, loss, losses[s])
    # a fresh trainer resumes from the final checkpoint: nothing to do
    again = _port_trainer().train(10, ckpt=ck)
    assert again["resumes"] == 1 and again["history"] == []


def test_mesh_and_device_refused_not_ignored():
    from repro_torch.parallel.resolve import AbstractMesh
    cfg = get_config("qwen3-14b", reduced=True)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    tr = Trainer(cfg, ShapeConfig(*SHAPE), mesh=mesh, device="cpu")
    assert tr.mesh is mesh and tr.rt.production   # the sharded step
    assert not Trainer(cfg, ShapeConfig(*SHAPE), device="cpu").rt.production
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg, ShapeConfig(*SHAPE))


def test_train_launcher_on_cpu(capsys, tmp_path):
    import json
    train_launcher.main(["--arch", "deepseek-moe-16b", "--reduced",
                         "--steps", "4", "--batch", "2", "--seq", "16",
                         "--amoeba", "--grad-compression", "--ckpt-dir",
                         str(tmp_path), "--ckpt-every", "2",
                         "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["steps"] == 4 and out["resumes"] == 0
    assert out["divergence_mean"] > 0 and np.isfinite(out["loss_last"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_2", "step_4"]
