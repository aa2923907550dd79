"""The benchmark's tests import ``kppbench`` from the repository's root."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

# the check's tests run the CLI in-process, several at once under
# xdist: a few threads each keep the host's cores from oversubscription
torch.set_num_threads(2)
