import sys

from genomax_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
