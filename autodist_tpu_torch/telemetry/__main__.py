"""``python -m autodist_tpu_torch.telemetry`` — trace, drift, goodput and
flight-recorder tooling."""
import sys

from autodist_tpu_torch.telemetry.cli import main

if __name__ == "__main__":
    sys.exit(main())
