"""A configuration file's ``model`` tree as the port's ``Config`` (the plain
reference reads the tree itself).

The tree holds every field of the preset's sections as they are run
(``data``, ``test``, ``point``, ``patch``, ``match``, ``static``, ``stage``).
The port's is built from the file and held to it field by field, so a
preset that changes under the benchmark is refused rather than measured as
the same configuration.
"""

from __future__ import annotations

import dataclasses


def _apply(base, tree: dict):
    kw = {}
    for section, values in tree.items():
        if isinstance(values, dict):
            sub = getattr(base, section)
            fields = {f.name: f for f in dataclasses.fields(sub)}
            unknown = set(values) - set(fields)
            if unknown:
                raise KeyError(f"configuration section {section!r} has no "
                               f"fields {sorted(unknown)}")
            vals = {k: tuple(v) if isinstance(v, list) else v
                    for k, v in values.items()}
            kw[section] = dataclasses.replace(sub, **vals)
        else:
            kw[section] = values
    return dataclasses.replace(base, **kw)


def _norm(v):
    return [_norm(x) for x in v] if isinstance(v, (list, tuple)) else v


def _held(cfg, tree: dict) -> None:
    got = dataclasses.asdict(cfg)
    for section, values in tree.items():
        have = got[section]
        if isinstance(values, dict):
            for k, v in values.items():
                h = have[k]
                if _norm(h) != _norm(v):
                    raise ValueError(f"{section}.{k}: the run has {h!r}, the "
                                     f"configuration file {v!r}")
        elif have != values:
            raise ValueError(f"{section}: the run has {have!r}, the file "
                             f"{values!r}")


def port_config(conf: dict):
    """The port's ``Config``: its preset with every value of the file."""
    from buffer_tpu_torch.config import make_cfg
    cfg = _apply(make_cfg(conf["preset"]), conf["model"])
    _held(cfg, conf["model"])
    return cfg
