"""Rows the MoE's expert products compute over rows the router sent
them, over the window: the program's ``moe.slot_rows`` (G · E · C a
call) over ``moe.routed_rows`` (T · k a call).  1 where nothing is
padded."""


def read(run):
    d = run.data
    slots, routed = d.get("moe.slot_rows"), d.get("moe.routed_rows")
    return slots / routed if slots and routed else None
