"""The port's model configuration for a cell: the port's own config of
the architecture the configuration file names, with the file's ``port``
fields put in (the cut depth; every width is checked equal)."""
from __future__ import annotations

import dataclasses


def model_config(ctx):
    from repro_torch.configs import get_config
    port = ctx.config["port"]
    return dataclasses.replace(get_config(port["arch"]),
                               **port["fields"]).validate()
