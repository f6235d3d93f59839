import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":  # importing the package's modules must not run the gate
    sys.exit(main())
