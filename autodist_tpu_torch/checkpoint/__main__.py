"""``python -m autodist_tpu_torch.checkpoint`` — checkpoint lifecycle CLI."""
import sys

from autodist_tpu_torch.checkpoint.cli import main

if __name__ == "__main__":
    sys.exit(main())
