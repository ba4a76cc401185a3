"""`python -m cvpce_tpu_torch.cli`: the same entry point as the
`cvpce-torch` console script (pyproject.toml, [project.scripts])."""
import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
