"""The reference's config files and short flags (port of dsac_tpu/flags.py,
after core/properties.cpp:97-306).

A ``default.config`` file of ``key value`` lines is read first, then the
command line's ``-flag value`` pairs override it.  The flag names are the
reference's own, abbreviated and case-sensitive (-rI, -rRI, -rB, -rSS,
-rT2D, -rT3D, -rdraw, -fl, -xs, -ys, -sfl, -rxs, -rys, -rd, -iw, -ih;
-oscript, -sscript, -omodel, -smodel and -c are kept as strings), so a
7-Scenes scene's config file works unchanged.  The result is a frozen
DSACConfig and the string settings.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from dsac_tpu_torch.config import DataConfig, DSACConfig, NetConfig, PoseConfig
from dsac_tpu_torch.utils.logging import blue

# flag -> (section, field, type)
FLAG_TABLE = {
    "rI": ("pose", "num_hypotheses", int),
    "rRI": ("pose", "refinement_steps", int),
    "rB": ("pose", "inlier_count_cap", int),
    "rSS": ("pose", "gradient_subsample", float),
    "rT2D": ("pose", "inlier_threshold_2d", float),
    "rT3D": ("pose", "inlier_threshold_3d", float),
    "rdraw": ("pose", "random_draw", lambda v: bool(int(v))),
    "fl": ("data", "focal_length", float),
    "xs": ("data", "x_shift", float),
    "ys": ("data", "y_shift", float),
    "sfl": ("data", "secondary_focal_length", float),
    "rxs": ("data", "raw_x_shift", float),
    "rys": ("data", "raw_y_shift", float),
    "rd": ("data", "raw_data", lambda v: bool(int(v))),
    "iw": ("data", "image_width", int),
    "ih": ("data", "image_height", int),
}


def parse_config_file(path: str | Path, updates: dict | None = None) -> dict:
    """``key value`` lines -> a flag dict (properties.cpp:277-306): '#'
    starts a comment line, a key already present keeps its value, and
    unknown keys are kept as strings.  A missing file adds nothing."""
    updates = dict(updates or {})
    p = Path(path)
    if p.exists():
        for line in p.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            if len(toks) >= 2:
                updates.setdefault(toks[0], toks[1])
    return updates


def parse_argv(argv: list[str], updates: dict | None = None) -> dict:
    """``-flag value`` pairs -> a flag dict (properties.cpp:97-268); the
    command line wins over the config file."""
    updates = dict(updates or {})
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("-") and i + 1 < len(argv):
            updates[tok[1:]] = argv[i + 1]
            i += 2
        else:
            i += 1
    return updates


def build_config(flag_values: dict) -> tuple[DSACConfig, dict]:
    """A flag dict -> (DSACConfig, the remaining string settings)."""
    pose_kw, data_kw, strings = {}, {}, {}
    for k, v in flag_values.items():
        if k in FLAG_TABLE:
            section, field, typ = FLAG_TABLE[k]
            (pose_kw if section == "pose" else data_kw)[field] = typ(v)
        else:
            strings[k] = v
    return DSACConfig(pose=PoseConfig(**pose_kw), data=DataConfig(**data_kw),
                      net=NetConfig()), strings


def flag_values(argv: list[str] | None = None,
                config_name: str | None = None) -> dict:
    """The reference's order: the config file named by -c (or
    ``config_name``, else ``default``; ".config" is appended to a bare
    name, properties.cpp:283), then the command line's flags."""
    cli = parse_argv(list(argv or []))
    name = str(cli.get("c", config_name or "default"))
    path = name if name.endswith(".config") else f"{name}.config"
    flags = parse_config_file(path)
    flags.update(cli)
    return flags


def load(argv: list[str] | None = None,
         config_name: str | None = None) -> tuple[DSACConfig, dict]:
    """``flag_values`` -> (DSACConfig, string settings)."""
    return build_config(flag_values(argv, config_name))


def parse_with_flags(parser: argparse.ArgumentParser, argv=None):
    """argparse for the long options and the reference's short flags beside
    them (dsac_tpu/cli/common.py:194-200): returns (args, cfg, strings).
    A leftover ``--option`` is an error, as argparse alone would make it;
    ``args.flags_given`` names the flags that the command line or its
    config file set, and ``args.flag_argv`` holds the short flags as
    given."""
    args, rest = parser.parse_known_args(argv)
    unknown = [t for t in rest if t.startswith("--")]
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    values = flag_values(rest)
    args.flags_given, args.flag_argv = set(values), rest
    cfg, strings = build_config(values)
    return args, cfg, strings


def apply_string_flags(strings: dict | None) -> tuple[str | None,
                                                     str | None]:
    """The reference's model-file flags (properties.cpp:69-70;
    dsac_tpu/cli/common.py:291-317): -omodel and -smodel name the
    coordinate and score nets to load, a snapshot name (a trailing .net is
    stripped) or an npz artifact; returns them or Nones.  -oscript and
    -sscript named Lua training scripts, which neither the reference's
    rebuild nor the port has, so they warn."""
    strings = strings or {}
    for k in ("oscript", "sscript"):
        if k in strings:
            print(blue(f"WARNING: -{k} {strings[k]!r} ignored — the "
                       "reference's Lua training scripts are replaced by "
                       "models/ + config.py:NetConfig (no script files)."))

    def norm(name):
        v = strings.get(name)
        if v is None:
            return None
        return v[:-4] if v.endswith(".net") else v

    return norm("omodel"), norm("smodel")
