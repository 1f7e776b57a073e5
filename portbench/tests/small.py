"""Small versions of the cells, for driving whole runs on the CPU.

The limits here are set, as the cells' own are on the card, between the
readings of sound runs and of the fp8 control, but from runs at these
sizes on the CPU (4 seeds each): sound MLP rows read at most 0.0051 and
the control at least 0.047; sound training losses 1.2e-4, gradients
3.0e-3, changes 1.4e-2 against the control's 8.1e-4, 2.5e-2 and
8.1e-3 (its change does not separate here).
"""

QWEN = {
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 512,
    "port": {"arch": "qwen2-1.5b",
             "fields": {"n_layers": 2, "d_model": 64, "n_heads": 4,
                        "n_kv_heads": 2, "d_ff": 128, "vocab_size": 512,
                        "head_dim": 16}}}

MLP = {"config": QWEN, "traffic": {"rows": 48, "warmup_calls": 2},
       "limits": {"row_err": 0.015}}

CELLS = {
    "qwen2-1.5b.mlp-compile-t4096": MLP,
    "qwen2-1.5b.mlp-auto-t4096": MLP,
    "qwen2-1.5b.train-8x512": {
        "config": QWEN, "traffic": {"batch": 2, "seq": 16},
        "limits": {"loss_gap": 4e-4, "grad_gap": 1e-2, "change_gap": 3e-2}},
}
