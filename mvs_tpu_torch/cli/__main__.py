"""CLI dispatcher: python -m mvs_tpu_torch.cli
<train|infer|fuse|evaluate|profile> ..."""

from __future__ import annotations

import importlib
import sys

_COMMANDS = ("train", "infer", "fuse", "evaluate", "profile")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: python -m mvs_tpu_torch.cli "
              f"{{{'|'.join(_COMMANDS)}}} [args...]")
        raise SystemExit(0 if argv else 1)
    cmd, rest = argv[0], argv[1:]
    if cmd not in _COMMANDS:
        raise SystemExit(f"unknown command {cmd!r}; options: {_COMMANDS}")
    importlib.import_module(f"mvs_tpu_torch.cli.{cmd}").main(rest)


if __name__ == "__main__":
    main()
