"""Config-file support for CLI defaults.

A copy of ``cfrk_tpu/runtime/config.py`` (the port imports nothing of
the JAX package).  The reference's workflow layer was configured
through a HOCON site file (``swift/swift.conf`` — maxParallelTasks,
executionRetries, lazyErrors, workdir...).  The analog here is a small
JSON config, loadable via ``--config`` or auto-discovered as
``cfrk.json`` in the working directory, whose keys are CLI flag names
(dashes or underscores) and which argv always overrides.

Example ``cfrk.json``::

    {
      "k": 8,
      "mode": "perread",
      "batch-size": 16384,
      "max-parallel-tasks": 2,
      "retries": 1,
      "provenance": "prov.jsonl"
    }
"""

from __future__ import annotations

import json
import os

__all__ = [
    "load_config",
    "apply_config",
    "explicit_dests",
    "DEFAULT_CONFIG_NAME",
]

DEFAULT_CONFIG_NAME = "cfrk.json"


def load_config(path: str | None) -> dict:
    """Load a config dict; auto-discovers ``cfrk.json`` if path is None."""
    if path is None:
        if os.path.exists(DEFAULT_CONFIG_NAME):
            path = DEFAULT_CONFIG_NAME
        else:
            return {}
    with open(path) as f:
        cfg = json.load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"config {path} must be a JSON object")
    return {k.replace("-", "_"): v for k, v in cfg.items()}


def explicit_dests(argv, parser) -> set:
    """Destinations the user explicitly passed on the command line.

    Needed because argparse cannot distinguish "not given" from
    "explicitly set to the default" — without this, a config value
    would clobber an explicit ``--batch-size 8192``.  Argparse prefix
    abbreviations (``--batch`` for ``--batch-size``) resolve the same
    way argparse itself does: an unambiguous prefix of exactly one long
    option counts as explicit.
    """
    opts = parser._option_string_actions
    out = set()
    for tok in argv or []:
        if not tok.startswith("-"):
            continue
        name = tok.split("=", 1)[0]
        action = opts.get(name)
        if action is None and name.startswith("--") and len(name) > 2:
            # argparse allows unambiguous long-option abbreviation.
            matches = {
                a.dest
                for opt, a in opts.items()
                if opt.startswith("--") and opt.startswith(name)
            }
            if len(matches) == 1:
                out.add(matches.pop())
            continue
        if action is not None:
            out.add(action.dest)
    return out


def apply_config(args, cfg: dict, parser, explicit: set = frozenset()) -> None:
    """Fill parser-default values from the config; argv always wins.

    Only keys matching known argparse destinations are applied; unknown
    keys raise, so typos fail loudly.  Values are coerced through the
    option's ``type`` so e.g. a JSON string for an int flag errors
    cleanly instead of surfacing later as an opaque TypeError.
    """
    actions = {a.dest: a for a in parser._actions}
    for key, val in cfg.items():
        if key not in actions:
            raise SystemExit(f"unknown config key: {key!r}")
        if key in explicit:
            continue  # argv wins unconditionally
        action = actions[key]
        # Only apply when the arg still holds its parser default (covers
        # positional-derived values too).
        if getattr(args, key, None) != action.default:
            continue
        if action.type is not None and val is not None:
            try:
                val = action.type(val)
            except (TypeError, ValueError):
                raise SystemExit(
                    f"config key {key!r}: cannot convert {val!r} via "
                    f"{getattr(action.type, '__name__', action.type)}"
                )
        setattr(args, key, val)
