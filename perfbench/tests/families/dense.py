"""Reduced sizes of the dense decoder family for the CPU tests, and the
program's configuration fields they set."""

MODEL = {"d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 500, "vocab_padded": 512}

#: over MODEL on the card: a head dim at which training attends through
#: the flash kernels (``TRAIN_HEAD_DIMS``)
CARD = {"head_dim": 64}


def port_fields(m: dict) -> dict:
    return {"n_layers": m["n_layers"], "d_model": m["d_model"],
            "n_heads": m["n_heads"], "n_kv_heads": m["n_kv_heads"],
            "head_dim": m["head_dim"], "d_ff": m["d_ff"],
            "vocab_size": m["vocab_size"]}
