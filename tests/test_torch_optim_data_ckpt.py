"""The port's training substrates against the JAX reference: AdamW
(``optim/adamw.py``), the token pipeline (``data/pipeline.py``) and
checkpoints (``ckpt/checkpoint.py``).

* AdamW: one and five updates from the same numpy parameters, gradients
  and state, at 1e-6 (f32 arithmetic in another framework), with f32 and
  bf16 state and with int8 compression; the cosine schedule;
* ``SyntheticLM``: the same numpy draws, so batches are bit-equal, and the
  prefetching iterator restarts at any step;
* the port's counterparts of ``tests/test_substrates.py``'s optimizer, data
  and checkpoint tests;
* a checkpoint the reference wrote (f32 parameters and state, an int32
  step, bf16 error leaves) restores in the port, and one the port wrote
  restores in the reference.
"""

import pytest

torch = pytest.importorskip("torch")

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import pipeline as jdata
from repro.optim import adamw as jadamw
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data import pipeline as tdata
from repro_torch.models.params import P, params_from_numpy, tree_leaves
from repro_torch.optim import adamw

CPU = torch.device("cpu")
SHAPES = {"w": (6, 5), "blk": {"b": (7,), "k": (2, 3, 4)}}


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in shapes.items()}


def _np_tree(rng, scale=1.0):
    return _tree(lambda s: (rng.standard_normal(s) * scale).astype(np.float32))


def _close(got, want, tol):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)


# -- AdamW against the reference ------------------------------------------------

OPT_CASES = {
    "f32 state": dict(),
    "bf16 state": dict(state_dtype="bfloat16"),
    "int8 compression": dict(compress_int8=True),
}


@pytest.mark.parametrize("n_updates", [1, 5])
@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_updates_match_reference(case, n_updates):
    """The same parameters, state and gradients through ``n_updates`` steps
    of each package's ``apply_updates`` (the port's in place), with the
    reference's cosine schedule as ``lr_scale``: parameters, moments,
    errors, the step and ``grad_norm`` at 1e-6."""
    kw = dict(OPT_CASES[case])
    dt = kw.pop("state_dtype", "float32")
    jcfg = jadamw.AdamWConfig(lr=1e-2, state_dtype=getattr(jnp, dt), **kw)
    tcfg = adamw.AdamWConfig(lr=1e-2, state_dtype=getattr(torch, dt), **kw)
    rng = np.random.default_rng(0)
    jp = jax.tree.map(jnp.asarray, _np_tree(rng))
    jst = jadamw.init_state(jp, jcfg)
    tp = params_from_numpy(jp, CPU)
    tst = params_from_numpy(jst, CPU)
    assert tst["step"].dtype == torch.int32
    for _ in range(n_updates):
        grads = _np_tree(rng, scale=3.0)  # norms above grad_clip = 1: clipping on
        sched = jadamw.cosine_schedule(jst["step"] + 1, warmup=2, total=10)
        jp, jst, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, grads), jst, jcfg,
                                           lr_scale=sched)
        tsched = adamw.cosine_schedule(tst["step"] + 1, warmup=2, total=10)
        tp2, tst2, tm = adamw.apply_updates(tp, params_from_numpy(grads, CPU), tst, tcfg,
                                            lr_scale=tsched)
        assert tp2 is tp and tst2 is tst  # in place
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    _close(tp, jp, 1e-6)
    _close(tst["moments"], jst["moments"], 1e-6)
    assert int(tst["step"]) == int(jst["step"]) == n_updates
    assert {t.dtype for t in tree_leaves(tst["moments"])} == {tcfg.state_dtype}
    if tcfg.compress_int8:
        _close(tst["error"], jst["error"], 1e-6)


def test_state_specs_and_init_state_match_the_reference_tree():
    """The port's state tree has the reference's structure and dtypes, so a
    reference state carries across with ``params_from_numpy``."""
    jcfg = jadamw.AdamWConfig(compress_int8=True)
    tcfg = adamw.AdamWConfig(compress_int8=True)
    jp = jax.tree.map(jnp.asarray, _np_tree(np.random.default_rng(1)))
    jst = jadamw.init_state(jp, jcfg)
    tst = adamw.init_state(params_from_numpy(jp, CPU), tcfg)
    specs = adamw.state_specs(_tree(lambda s: P(s, (None,) * len(s))), tcfg)
    carried = params_from_numpy(jst, CPU)

    def walk(a, b, c, d):
        assert isinstance(a, dict) == isinstance(b, dict) == isinstance(c, dict) \
            == isinstance(d, dict)
        if isinstance(a, dict):
            assert sorted(a) == sorted(b) == sorted(c) == sorted(d)
            for k in a:
                walk(a[k], b[k], c[k], d[k])
        else:
            assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape) == tuple(d.shape)
            assert a.dtype == b.dtype == c.dtype
            assert str(d.dtype) == str(a.dtype).removeprefix("torch.")

    walk(tst, carried, specs, jst)


def test_cosine_schedule_equals_reference():
    """Exact in the warm-up and at the ends of the decay; on the decay the
    two frameworks' f32 ``cos`` may round its last bit differently (the
    reference's is the C library's ``cosf``), so there within one f32 ulp
    of values <= 1."""
    warm, total = 100, 10000
    steps = np.arange(0, 12000, 7, dtype=np.int32)
    want = np.asarray(jadamw.cosine_schedule(jnp.asarray(steps), warmup=warm, total=total))
    got = adamw.cosine_schedule(torch.from_numpy(steps), warmup=warm, total=total).numpy()
    assert got.dtype == np.float32
    exact = (steps <= warm) | (steps >= total)
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got, want, rtol=0, atol=np.finfo(np.float32).eps / 2)
    for s in (0, 1, 50, 100, 10000, 10001):
        one = adamw.cosine_schedule(torch.tensor(s, dtype=torch.int32), warmup=warm,
                                    total=total)
        assert float(one) == float(jadamw.cosine_schedule(jnp.int32(s), warmup=warm,
                                                          total=total))


# -- the reference's substrate tests, ported -----------------------------------

def test_adamw_optimizes_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    st = adamw.init_state(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, st, m = adamw.apply_updates(params, grads, st, cfg)
    assert float(params["w"].abs().max()) < 0.05
    assert int(st["step"]) == 200


def test_grad_clipping_bounds_update():
    cfg = adamw.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    st = adamw.init_state(params, cfg)
    _, _, m = adamw.apply_updates(params, {"w": torch.full((4,), 1e6)}, st, cfg)
    assert float(m["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_bf16_state_dtype():
    cfg = adamw.AdamWConfig(state_dtype=torch.bfloat16)
    st = adamw.init_state({"w": torch.zeros(8)}, cfg)
    assert st["moments"]["w"]["m"].dtype == torch.bfloat16


def test_int8_compression_error_feedback_converges():
    cfg = adamw.AdamWConfig(lr=0.5, weight_decay=0.0, compress_int8=True, grad_clip=0.0)
    params = {"w": torch.tensor([1.0, -1.0, 50.0])}  # mixed magnitudes
    st = adamw.init_state(params, cfg)
    assert "error" in st
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, st, _ = adamw.apply_updates(params, grads, st, cfg)
    assert float(params["w"].abs().max()) < 1.0


def test_cosine_schedule_shape():
    s = adamw.cosine_schedule(torch.tensor(0), warmup=10, total=100)
    e = adamw.cosine_schedule(torch.tensor(100), warmup=10, total=100)
    p = adamw.cosine_schedule(torch.tensor(10), warmup=10, total=100)
    assert float(s) == 0.0
    assert float(p) == pytest.approx(1.0)
    assert float(e) == pytest.approx(0.1, abs=1e-6)


def test_synthetic_batches_deterministic_and_restartable():
    cfg = tdata.DataConfig(seq_len=16, global_batch=4, vocab=100, seed=1)
    src = tdata.SyntheticLM(cfg)
    a = src.batch_at(7, 4, 0)
    b = src.batch_at(7, 4, 0)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = src.batch_at(8, 4, 0)
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (4, 16)
    assert (a["tokens"] < 100).all()
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_host_shard_spec_single_host():
    spec = tdata.HostShardSpec.current(32)
    assert spec.local_batch == 32 and spec.offset == 0


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"step": torch.tensor(5, dtype=torch.int32)}}
    for s in (10, 20, 30):
        mgr.save(s, state, blocking=True)
    assert mgr.latest_step() == 30
    kept = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(kept) == 2
    step, got = mgr.restore()
    assert step == 30
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 5


def test_checkpoint_async_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(3)})
    mgr.wait()
    step, got = mgr.restore()
    assert step == 1 and float(got["x"].sum()) == 3.0


def test_restore_empty_dir(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore() == (None, None)


def test_async_save_copies_before_an_in_place_update(tmp_path):
    """The trainer updates its tensors in place right after ``save``
    returns: the checkpoint holds the values at the save."""
    mgr = CheckpointManager(str(tmp_path))
    x = torch.zeros(1 << 16)
    mgr.save(1, {"x": x})
    x.add_(1.0)
    mgr.wait()
    assert float(CheckpointManager(str(tmp_path)).restore()[1]["x"].abs().max()) == 0.0


def test_checkpoint_save_clears_a_stale_temp_dir_and_keeps_latest(tmp_path):
    """A failed earlier try's temp files are cleared before a step is
    written; saving the step LATEST names again writes nothing; a step
    directory LATEST does not name is replaced whole."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, {"x": torch.zeros(3)}, blocking=True)
    stale = tmp_path / ".tmp_step_00000006"
    stale.mkdir()
    (stale / "shard_1.npz").write_bytes(b"stale")
    mgr.save(6, {"x": torch.ones(3)}, blocking=True)
    assert sorted(os.listdir(tmp_path / "step_00000006")) == ["MANIFEST.json", "shard_0.npz"]
    written = os.stat(tmp_path / "step_00000006" / "MANIFEST.json").st_mtime_ns
    mgr.save(6, {"x": torch.full((3,), 9.0)}, blocking=True)
    assert os.stat(tmp_path / "step_00000006" / "MANIFEST.json").st_mtime_ns == written
    step, got = mgr.restore(4)
    mgr.save(5, got)            # a later step LATEST no longer names
    mgr.wait()
    mgr.save(6, {"x": torch.full((3,), 2.0)}, blocking=True)
    assert mgr.latest_step() == 6
    assert float(mgr.restore()[1]["x"].sum()) == 6.0
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".")]


def test_checkpoint_wait_raises_when_a_rank_never_writes(tmp_path, monkeypatch):
    """Rank 0 of two gives up on the missing rank's file after the timeout:
    ``wait`` raises, and LATEST keeps the previous step."""
    monkeypatch.setattr(ckpt_mod, "RANKS_TIMEOUT_S", 0.05)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(2)}, blocking=True)
    mgr.world = 2
    mgr.save(2, {"x": torch.ones(2)})
    with pytest.raises(TimeoutError, match=r"ranks \[1\] wrote no checkpoint file"):
        mgr.wait()
    assert mgr.latest_step() == 1
    mgr.wait()                  # the error is raised once


# -- data and checkpoints across the two packages ---------------------------------

@pytest.mark.parametrize("offset", [0, 3])
def test_synthetic_batches_bit_equal_to_reference(offset):
    jcfg = jdata.DataConfig(seq_len=33, global_batch=6, vocab=517, seed=4)
    tcfg = tdata.DataConfig(seq_len=33, global_batch=6, vocab=517, seed=4)
    for step in (0, 1, 9, 1234):
        want = jdata.SyntheticLM(jcfg).batch_at(step, 3, offset)
        got = tdata.SyntheticLM(tcfg).batch_at(step, 3, offset)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("start", [0, 5])
def test_batches_iterator_restarts_at_any_step(start):
    """The prefetching iterator yields tensors on the device, step ``start``
    first, each the reference's ``batch_at`` of its step; closing it stops
    the producer."""
    cfg = tdata.DataConfig(seq_len=8, global_batch=2, vocab=50, seed=2, prefetch=2)
    src = jdata.SyntheticLM(jdata.DataConfig(seq_len=8, global_batch=2, vocab=50, seed=2))
    it = tdata.batches(cfg, CPU, start_step=start)
    for step in range(start, start + 4):
        got = next(it)
        want = src.batch_at(step, 2, 0)
        assert got["tokens"].dtype == torch.int32 and got["tokens"].device == CPU
        np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
        np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    it.close()


def test_memmap_source_matches_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.uint16).tofile(path)
    jcfg = jdata.DataConfig(seq_len=7, global_batch=4, vocab=1000, source=f"memmap:{path}")
    tcfg = tdata.DataConfig(seq_len=7, global_batch=4, vocab=1000, source=f"memmap:{path}")
    for step in (0, 3, 40):
        want = jdata.make_source(jcfg).batch_at(step, 2, 2)
        got = tdata.make_source(tcfg).batch_at(step, 2, 2)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def _ref_train_state():
    cfg = jadamw.AdamWConfig(compress_int8=True)
    rng = np.random.default_rng(5)
    params = jax.tree.map(jnp.asarray, _np_tree(rng))
    st = jadamw.init_state(params, cfg)
    params, st, _ = jadamw.apply_updates(params, jax.tree.map(jnp.asarray, _np_tree(rng)),
                                         st, cfg)
    return {"params": params, "opt": st}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """f32 parameters and moments, the int32 step and the bf16 error leaves
    the reference wrote come back bit for bit, on the given device."""
    state = _ref_train_state()
    JCheckpointManager(str(tmp_path)).save(7, state, blocking=True)
    step, got = CheckpointManager(str(tmp_path)).restore(device=CPU)
    assert step == 7
    want = params_from_numpy(state, CPU)
    assert sorted(_paths(got)) == sorted(_paths(want))
    for k, w in _paths(want).items():
        g = _paths(got)[k]
        assert g.dtype == w.dtype and g.shape == w.shape and g.device == CPU, k
        assert torch.equal(g, w), k


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = params_from_numpy(_ref_train_state(), CPU)
    CheckpointManager(str(tmp_path)).save(3, state, blocking=True)
    with open(tmp_path / "step_00000003" / "MANIFEST.json") as f:
        manifest = json.load(f)
    assert manifest["leaves"]["opt/error/w"]["dtype"] == "bfloat16"
    step, got = JCheckpointManager(str(tmp_path)).restore()
    assert step == 3
    for k, w in _paths(state).items():
        g = _paths(got)[k]
        if w.dtype == torch.bfloat16:  # numpy reads the bits back as uint16
            g = torch.from_numpy(np.asarray(g).view(np.int16)).view(torch.bfloat16)
        else:
            g = torch.from_numpy(np.asarray(g))
        assert torch.equal(g, w), k


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
