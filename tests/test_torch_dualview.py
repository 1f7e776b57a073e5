"""The port's DualView runtime: lazy, flag-driven host↔device copies
(numpy host side, torch device side), and the compiled module's weights
crossing to the device once, on first use."""
import numpy as np
import torch

from repro_torch.core import dualview, pipeline
from repro_torch.core.dualview import TRANSFERS, DualView
from repro_torch.core.options import CompileOptions


def test_sync_copies_only_when_the_other_side_changed():
    dualview.reset_transfer_stats()
    dv = DualView.from_host(np.arange(6, dtype=np.float32).reshape(2, 3),
                            device="cpu")
    assert dv.modified_host and not dv.modified_device
    dev = dv.device()
    assert isinstance(dev, torch.Tensor) and dev.tolist() == \
        [[0, 1, 2], [3, 4, 5]]
    assert TRANSFERS["h2d"] == 1
    dv.device()                       # clean: one flag check, no copy
    assert TRANSFERS["h2d"] == 1 and TRANSFERS["sync_calls"] == 2
    dv.set_device(dev * 2)
    assert dv.modified_device
    assert dv.host().tolist() == [[0, 2, 4], [6, 8, 10]]
    assert TRANSFERS["d2h"] == 1
    dv.host()
    assert TRANSFERS["d2h"] == 1


def test_children_alias_the_root_and_share_flags():
    dv = DualView.from_host(np.zeros((4, 4), np.float32), device="cpu")
    row = dv.subview(1)
    assert row.shape == (4,)
    row.set_host(np.ones(4, np.float32))
    assert dv.modified_host and dv.host_view()[1].tolist() == [1.0] * 4
    assert dv.device()[1].tolist() == [1.0] * 4
    assert row.device().tolist() == [1.0] * 4


def test_device_tensor_is_adopted_without_a_host_copy():
    dualview.reset_transfer_stats()
    t = torch.arange(3.0)
    dv = DualView.from_device(t)
    assert dv.device() is t and TRANSFERS["h2d"] == 0


def test_compiled_weights_cross_once_on_first_call():
    fn, specs, (ex,) = pipeline._demo_mlp()
    mod = pipeline.compile(fn, *specs,
                           options=CompileOptions(target="cuda", device="cpu"))
    dualview.reset_transfer_stats()
    mod(ex)
    first = TRANSFERS["h2d"]
    mod(ex)
    assert first == len(mod.forward.const_views) == 3
    assert TRANSFERS["h2d"] == first       # lazy: clean views copy nothing
