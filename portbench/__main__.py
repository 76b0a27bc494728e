"""``python3 -m portbench``: the same as ``python3 portbench/run.py``."""
import sys

from portbench.run import main

sys.exit(main())
