"""The training substrate of the port, held to the JAX reference on the
CPU: the optimizer (``optim``), the synthetic data pipeline (``data``),
the checkpoint manager (``checkpoint``) and the fault-tolerance helpers
(``runtime.fault``).

``opt_update`` takes the same numpy trees in both packages (AdamW,
Adafactor, the ``bf16`` and ``int8_ef`` gradient transforms, a bf16
master) over three chained steps, and every new parameter and state
leaf agrees to 1e-6 of its largest entry, every metric to rtol 1e-6.
``batch_np`` equals the reference's bit for bit.  The rest mirrors ``tests/test_optim_data.py`` and
``tests/test_checkpoint.py`` on torch trees, plus bf16 leaves carried
through a checkpoint bit for bit.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import numpy_to_torch  # noqa: E402
from repro_torch.core.dualview import (TRANSFERS, DualView,  # noqa: E402
                                       tree_sync_host)
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.models.spec import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.runtime import (PreemptionHandler, Retrier,  # noqa: E402
                                 StragglerDetector)

RTOL = 1e-6     # the optimizer: the same f32 formula in both packages


def _tree(rng, scale=1.0):
    """A parameter-shaped numpy tree: a vector, a matrix, a stacked 3-D
    leaf, nested as a model's are."""
    return {"b": (rng.standard_normal(7) * scale).astype(np.float32),
            "w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "layers": {"k": (rng.standard_normal((3, 4, 9)) * scale)
                       .astype(np.float32)}}


def _to_jax(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype or a.dtype), tree)


def _to_torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None else t


def _host(tree):
    """A JAX or torch tree as f32 numpy (bf16 widened exactly)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(jnp.asarray(tree, jnp.float32))


def _assert_trees(got, want, rtol=RTOL, path=()):
    """Each leaf to ``rtol`` of its largest entry: XLA contracts
    ``b1 * m + (1 - b1) * g`` into a fused multiply-add where torch
    rounds twice, and where the two terms cancel an entry's own relative
    error grows past the f32 rounding of the leaf's scale."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees(got[k], want[k], rtol, path + (k,))
        return
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=str(path))


HPARAMS = {
    "adamw": dict(kind="adamw"),
    "adamw_clip": dict(kind="adamw", clip_norm=0.5),
    "adafactor": dict(kind="adafactor"),
    "adamw_bf16_grads": dict(kind="adamw", grad_transform="bf16"),
    "adamw_int8_ef": dict(kind="adamw", grad_transform="int8_ef"),
    "adafactor_int8_ef": dict(kind="adafactor", grad_transform="int8_ef"),
}


@pytest.mark.parametrize("master", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(HPARAMS))
def test_opt_update_matches_reference(name, master, rng):
    kw = {**dict(lr=1e-2, warmup_steps=2, total_steps=10,
                 weight_decay=0.1, clip_norm=1.0), **HPARAMS[name]}
    jhp, thp = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    params = _tree(rng)
    jdt, tdt = jnp.dtype(master), getattr(torch, master)
    jp, tp = _to_jax(params, jdt), _to_torch(params, tdt)
    js, ts = jopt.init_opt_state(jp, jhp), topt.init_opt_state(tp, thp)
    for step in range(3):
        grads = _tree(rng, scale=0.3 + step)     # bf16, as a step hands them
        jg = _to_jax(grads, jnp.bfloat16)
        tg = _to_torch(grads, torch.bfloat16)
        jp, js, jm = jopt.opt_update(jp, jg, js, jhp)
        tp, ts, tm = topt.opt_update(tp, tg, ts, thp)
        for leaf in tree_leaves(tp):
            assert leaf.dtype == tdt
        _assert_trees(_host(tp), _host(jp))
        _assert_trees(_host({k: v for k, v in ts.items() if k != "step"}),
                      _host({k: v for k, v in js.items() if k != "step"}))
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=RTOL)


def test_opt_update_leaves_its_inputs(rng):
    hp = topt.OptimizerConfig(warmup_steps=0)
    p = _to_torch(_tree(rng))
    before = {k: v.clone() for k, v in tree_map(lambda t: t, p).items()
              if isinstance(v, torch.Tensor)}
    st = topt.init_opt_state(p, hp)
    topt.opt_update(p, _to_torch(_tree(rng)), st, hp)
    for k, v in before.items():
        assert torch.equal(p[k], v)
    assert int(st["step"]) == 0


def test_lr_schedule_matches_reference():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_ratio=0.1),
               dict(lr=3e-4, warmup_steps=0, total_steps=7),
               dict(lr=1e-3, warmup_steps=5, total_steps=5)):
        jhp, thp = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
        for s in range(0, 121, 3):
            np.testing.assert_allclose(
                float(topt.lr_at(s, thp)),
                float(jopt.lr_at(jnp.int32(s), jhp)), rtol=RTOL)
    hp = topt.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                              min_lr_ratio=0.1)
    assert float(topt.lr_at(0, hp)) == 0.0
    assert float(topt.lr_at(10, hp)) == pytest.approx(1.0)
    assert float(topt.lr_at(torch.tensor(100, dtype=torch.int32), hp)) == \
        pytest.approx(0.1, rel=1e-3)


def test_global_norm_and_clip_match_reference(rng):
    tree = _tree(rng, scale=4.0)
    np.testing.assert_allclose(float(topt.global_norm(_to_torch(tree))),
                               float(jopt.global_norm(_to_jax(tree))),
                               rtol=RTOL)
    hp = topt.OptimizerConfig(clip_norm=1.0, warmup_steps=0,
                              min_lr_ratio=1.0)
    p = {"w": torch.zeros(4)}
    st = topt.init_opt_state(p, hp)
    new_p, _, metrics = topt.opt_update(p, {"w": torch.full((4,), 100.0)},
                                        st, hp)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    # clipped to norm 1: the first Adam step moves each entry by lr
    np.testing.assert_allclose(new_p["w"].numpy(), -hp.lr, rtol=1e-5)


def test_adamw_matches_reference_formulas(rng):
    hp = topt.OptimizerConfig(kind="adamw", lr=1e-2, warmup_steps=0,
                              total_steps=10**9, min_lr_ratio=1.0,
                              weight_decay=0.0, clip_norm=0.0)
    p = {"w": torch.from_numpy(rng.standard_normal(5).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal(5).astype(np.float32))}
    st = topt.init_opt_state(p, hp)
    new_p, st, _ = topt.opt_update(p, g, st, hp)
    m = 0.1 * g["w"].numpy()
    v = 0.05 * g["w"].numpy() ** 2
    mh, vh = m / (1 - 0.9), v / (1 - 0.95)
    exp = p["w"].numpy() - 1e-2 * mh / (np.sqrt(vh) + hp.eps)
    np.testing.assert_allclose(new_p["w"].numpy(), exp, rtol=1e-5)


def test_adafactor_reduces_loss_quadratic(rng):
    hp = topt.OptimizerConfig(kind="adafactor", lr=0.1, warmup_steps=0,
                              min_lr_ratio=1.0, weight_decay=0.0,
                              clip_norm=0.0)
    target = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    p = {"w": torch.zeros((8, 8))}
    st = topt.init_opt_state(p, hp)
    assert st["fac"]["w"]["vr"].shape == (8,)
    for _ in range(60):
        p, st, _ = topt.opt_update(p, {"w": 2 * (p["w"] - target)}, st, hp)
    assert float(torch.mean((p["w"] - target) ** 2)) < 0.15


def test_grad_transform_int8_error_feedback(rng):
    hp = topt.OptimizerConfig(grad_transform="int8_ef", warmup_steps=0,
                              clip_norm=0.0, weight_decay=0.0,
                              min_lr_ratio=1.0, lr=1.0)
    p = {"w": torch.zeros(64)}
    st = topt.init_opt_state(p, hp)
    g = {"w": torch.from_numpy(rng.standard_normal(64).astype(np.float32))
         * 1e-3}
    _, st2, _ = topt.opt_update(p, g, st, hp)
    # quantization residual is retained for the next step
    assert float(torch.sum(torch.abs(st2["ef"]["w"]))) > 0
    assert float(torch.sum(torch.abs(st["ef"]["w"]))) == 0


def test_bf16_master_keeps_f32_factored_moments(rng):
    hp = topt.OptimizerConfig(kind="adafactor", warmup_steps=0)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    p = {"w": torch.from_numpy(w).to(torch.bfloat16),
         "b": torch.ones(4, dtype=torch.bfloat16)}
    st = topt.init_opt_state(p, hp)
    g = tree_map(lambda t: torch.ones_like(t), p)
    new_p, st, _ = topt.opt_update(p, g, st, hp)
    assert new_p["w"].dtype == torch.bfloat16
    assert st["fac"]["w"]["vc"].dtype == st["fac"]["b"]["v"].dtype == \
        torch.float32


# -- data pipeline --------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(vocab_size=101, seq_len=16, global_batch=4, seed=7),
    dict(vocab_size=512, seq_len=64, global_batch=8, seed=0),
    dict(vocab_size=151936, seq_len=33, global_batch=3, seed=123,
         noise=0.2),
])
def test_batches_equal_the_reference_bit_for_bit(cfg):
    ours = SyntheticLMDataset(DataConfig(**cfg), device="cpu")
    ref = JDataset(JDataConfig(**cfg))
    assert dataclasses.asdict(ours.cfg) == dataclasses.asdict(ref.cfg)
    for index in (0, 1, 5, 1000, 2**31 - 1):
        got, want = ours.batch_np(index), ref.batch_np(index)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=101, seq_len=16, global_batch=4, seed=7)
    ds = SyntheticLMDataset(cfg, device="cpu")
    b5a = ds.batch_np(5)
    b5b = SyntheticLMDataset(cfg, device="cpu").batch_np(5)  # = resume
    np.testing.assert_array_equal(b5a["tokens"], b5b["tokens"])
    assert b5a["tokens"].shape == (4, 16)
    assert (b5a["labels"][:, :-1] == b5a["tokens"][:, 1:]).all()


def test_data_has_learnable_structure():
    cfg = DataConfig(vocab_size=64, seq_len=256, global_batch=8, seed=0,
                     noise=0.0)
    t = SyntheticLMDataset(cfg, device="cpu").batch_np(0)["tokens"]
    pairs = set(zip(t[:, :-1].reshape(-1).tolist(),
                    t[:, 1:].reshape(-1).tolist()))
    assert len(pairs) < 0.5 * 64 * 64


def test_prefetch_iterator_stages_through_dualviews():
    cfg = DataConfig(vocab_size=32, seq_len=8, global_batch=2)
    ds = SyntheticLMDataset(cfg, device="cpu")
    it = ds.iter_from(3, prefetch=2)
    i, dv_batch = next(it)
    assert i == 3
    np.testing.assert_array_equal(dv_batch["tokens"].host(),
                                  ds.batch_np(3)["tokens"])
    before = TRANSFERS["h2d"]
    dev = dv_batch["labels"].device()
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    np.testing.assert_array_equal(dev.numpy(), ds.batch_np(3)["labels"])
    assert TRANSFERS["h2d"] == before + 1
    assert next(it)[0] == 4
    it.close()


def test_tree_sync_host_copies_only_what_changed():
    a = DualView.from_device(torch.arange(4.0), name="a")
    b = DualView.from_device(torch.ones(3, dtype=torch.bfloat16), name="b")
    c = DualView.from_host(np.zeros(2, np.float32), name="c")
    tree = {"x": a, "y": [b, (c, 7)]}
    assert tree_sync_host(tree) == 2          # a and b: device-only
    assert tree_sync_host(tree) == 0          # nothing changed
    a.set_device(torch.full((4,), 2.0))
    assert tree_sync_host(tree) == 1
    np.testing.assert_array_equal(a.host_view(), np.full(4, 2.0))


# -- checkpoints --------------------------------------------------------

def _state(rng, scale=1.0):
    return {"params": {"w": torch.from_numpy(
        (rng.standard_normal((4, 8)) * scale).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal(8).astype(np.float32))},
        "opt": {"step": torch.tensor(3, dtype=torch.int32)}}


def test_save_restore_exact(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path))
    st = _state(rng)
    mgr.save(10, st)
    got, step = mgr.restore(device="cpu")
    assert step == 10
    torch.testing.assert_close(got["params"]["w"], st["params"]["w"],
                               rtol=0, atol=0)
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 3


def test_bf16_and_mixed_leaves_round_trip_bit_for_bit(tmp_path, rng):
    bf = torch.from_numpy(rng.standard_normal((5, 3)).astype(
        np.float32)).to(torch.bfloat16)
    bf[0, 0] = float("inf")
    bf[1, 1] = -0.0
    tree = {"bf": bf, "seq": [torch.arange(3, dtype=torch.int64),
                              (np.float64(2.5), 4)],
            "np": rng.standard_normal(3).astype(np.float32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        assert json.load(f)["dtypes"] == {"bf": "bfloat16"}
    got, _ = mgr.restore(device="cpu")
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"].view(torch.int16), bf.view(torch.int16))
    assert isinstance(got["seq"], list) and isinstance(got["seq"][1], tuple)
    assert torch.equal(got["seq"][0], tree["seq"][0])
    assert float(got["seq"][1][0]) == 2.5 and int(got["seq"][1][1]) == 4
    np.testing.assert_array_equal(got["np"].numpy(), tree["np"])
    # the reference's own numpy reader takes the bits unchanged
    raw = np.load(tmp_path / "step_00000001" / "bf.npy")
    assert raw.dtype == np.int16
    np.testing.assert_array_equal(
        numpy_to_torch(raw).view(torch.bfloat16).float().numpy(),
        bf.float().numpy())


def test_atomic_no_partial_visible(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(rng))
    crash = tmp_path / "tmp.999.1234"
    crash.mkdir()
    (crash / "x.npy").write_bytes(b"garbage")
    (tmp_path / "step_00000999").mkdir()     # no manifest.json → incomplete
    assert mgr.latest() == 1


def test_keep_k_gc(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep_k=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(rng))
    assert mgr.all_steps() == [3, 4]


def test_lazy_staging_counts_device_copies(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path))
    st = _state(rng)
    st["host"] = np.arange(3)                    # a host leaf: no copy
    before = TRANSFERS["d2h"]
    mgr.save(1, st)
    assert TRANSFERS["d2h"] == before + 3        # w, b, step
    mgr.save(2, st)
    with open(os.path.join(mgr.dir, "step_00000002", "manifest.json")) as f:
        man = json.load(f)
    assert man["n_leaves"] == 4 and man["lazy_hits"] == 1
    assert TRANSFERS["d2h"] == before + 6


@pytest.mark.parametrize("async_write", [False, True])
def test_save_holds_no_saved_tensor(tmp_path, rng, async_write):
    """A saved state is freed once the caller drops it: the manager keeps
    only host copies, and those only until they are written."""
    import gc
    import weakref
    mgr = CheckpointManager(str(tmp_path), async_write=async_write)
    st = _state(rng)
    refs = [weakref.ref(t) for t in tree_leaves(st)]
    mgr.save(1, st, block=False)
    mgr.save(2, st, block=False)
    mgr.wait()
    del st
    gc.collect()
    assert all(r() is None for r in refs)
    got, step = mgr.restore(device="cpu")
    assert step == 2 and got["params"]["w"].shape == (4, 8)


def test_restore_onto_a_device(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path))
    st = _state(rng)
    mgr.save(5, st)
    got, step = mgr.restore(5, device="cpu")
    assert step == 5 and got["params"]["b"].device.type == "cpu"
    torch.testing.assert_close(got["params"]["b"], st["params"]["b"],
                               rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(device="cpu")


def test_async_save(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(7, _state(rng), block=False)
    mgr.wait()
    assert mgr.latest() == 7


# -- fault tolerance --------------------------------------------------------

def test_straggler_detector_flags_outlier():
    import time
    det = StragglerDetector(threshold=1.5, warmup_steps=0)
    for step in range(5):
        det.start_step()
        time.sleep(0.01)
        det.end_step(step)
    det.start_step()
    time.sleep(0.08)
    assert det.end_step(5) is not None
    assert det.flagged[-1][0] == 5


def test_retrier_recovers_then_exhausts():
    r = Retrier(max_retries=2)
    calls, failures = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError("once")
        return "ok"

    assert r.run(flaky, lambda e, a: failures.append(a)) == "ok"
    assert failures == [1]

    def always_fail():
        calls.append(1)
        raise RuntimeError("boom")

    calls.clear()
    with pytest.raises(RuntimeError):
        r.run(always_fail, lambda e, a: None)
    assert len(calls) == 3


def test_preemption_handler_flags_sigterm():
    import signal
    h = PreemptionHandler(install=False)
    assert not h.requested
    h._on_term(signal.SIGTERM, None)
    assert h.requested
    h.uninstall()
