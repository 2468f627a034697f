"""The benchmark's own tests: on the CPU, with the checkout's root on the
path (witbench is a package there)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the plain versions run many small tensor operations: a few threads a
# test process, not one a core (tests run side by side)
import torch  # noqa: E402

torch.set_num_threads(2)
