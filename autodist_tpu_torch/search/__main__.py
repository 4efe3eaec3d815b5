"""Entry point for ``python -m autodist_tpu_torch.search``."""
import sys

from autodist_tpu_torch.search.cli import main

if __name__ == "__main__":
    sys.exit(main())
