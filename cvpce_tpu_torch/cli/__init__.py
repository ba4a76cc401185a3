"""cvpce-torch: the port's command line; counterpart of
cvpce_tpu/cli/__init__.py.

argparse in place of click, which the card's machine lacks, with the
JAX CLI's whole tree: the `gln`, `dihe`, `datasets` (with its `sku110k`,
`gp`, `grozi` and `internal` subgroups) and `misc` groups and the
top-level `eval-product-detection`, `eval-planograms`, `rebuild-scene`
and `plot-planogram-eval`. Every option keeps its click name, default, nargs
and choices; click's `multiple=True` is an appending option whose
default stands while the option is absent (`Multiple`). A usage error
exits with code 2, as click's does, whether argparse finds it or a
command body raises `UsageError`.

One global `--device` (default `cuda`) takes the place of the JAX
package's `JAX_PLATFORMS`: without a card, a command raises unless it is
given `--device cpu`; nothing falls back to the CPU. Float32 work runs
in float32 (TF32 off), as the library is held to the JAX package.

    cvpce-torch [--device cuda|cpu] COMMAND ...
    python -m cvpce_tpu_torch.cli [--device cuda|cpu] COMMAND ...

Commands import the library inside their bodies, as the JAX package's
do, so `--help` stays quick and the modules that the library imports
(train/loops.py reads cli/common.py) never import a command.
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Sequence

class UsageError(Exception):
    """Bad usage found inside a command (click.UsageError): the command's
    parser reports it and exits with code 2."""


class Multiple(argparse.Action):
    """click's `multiple=True`: each use of the option adds one value to
    a tuple; while the option is absent its default stands (argparse's
    `append` would add to the default)."""

    def __call__(self, parser, namespace, values, option_string=None):
        given = getattr(namespace, self.dest)
        base = () if given is self.default else tuple(given)
        setattr(namespace, self.dest, base + (values,))


def existing_path(value: str) -> str:
    """click.Path(exists=True)."""
    if not os.path.exists(value):
        raise argparse.ArgumentTypeError(f"Path '{value}' does not exist.")
    return value


def command(group, name: str, run: Callable) -> argparse.ArgumentParser:
    """A command parser under `group` that dispatches to `run`, its help
    the first paragraph of `run`'s docstring."""
    doc = (run.__doc__ or "").strip()
    parser = group.add_parser(
        name, help=doc.split("\n\n")[0].replace("\n", " "),
        description=doc,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.set_defaults(_run=run, _parser=parser)
    return parser


def canvas_option(parser, text: str = "detector canvas (h w)") -> None:
    parser.add_argument("--canvas", nargs=2, type=int, default=(832, 1344),
                        metavar=("H", "W"), help=text)


def build_parser() -> argparse.ArgumentParser:
    from . import datasets, dihe, gln, misc
    from . import eval as eval_cmds

    parser = argparse.ArgumentParser(
        prog="cvpce-torch",
        description="cvpce-torch: planogram compliance evaluation on "
                    "PyTorch and CUDA.\n\nTypical flow:\n"
                    "  gln train / gln eval   product proposal detector "
                    "(SKU-110K)\n"
                    "  dihe pretrain-gan / dihe train   embedding "
                    "encoder (Grocery Products)\n"
                    "  eval-planograms        end-to-end compliance "
                    "scoring",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda",
                        help="where every command runs: cuda (the "
                             "default; raises without a card) or cpu")
    commands = parser.add_subparsers(dest="command", metavar="COMMAND",
                                     required=True)
    gln.register(commands)
    dihe.register(commands)
    datasets.register(commands)
    misc.register(commands)
    eval_cmds.register(commands)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Parse `argv` (sys.argv[1:] when None) and run the command on the
    device of `--device`, TF32 off while it runs. Returns 0; usage
    errors raise SystemExit(2), and a failing command raises its
    exception."""
    import torch

    from ..utils import resolve_device

    args = vars(build_parser().parse_args(argv))
    run, parser = args.pop("_run"), args.pop("_parser")
    for level in ("command", "group_command", "subgroup_command"):
        args.pop(level, None)
    device = resolve_device(args.pop("device"))
    args = {k: tuple(v) if isinstance(v, list) else v
            for k, v in args.items()}
    # f32 is f32: cuDNN would run f32 convolutions in TF32 by default
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        run(device=device, **args)
    except UsageError as e:
        parser.error(str(e))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return 0
