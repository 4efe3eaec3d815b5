"""Entry point for ``python -m autodist_tpu_torch.analysis``."""
import sys

from autodist_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
