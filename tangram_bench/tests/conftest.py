import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

import pytest  # noqa: E402
import torch  # noqa: E402


@pytest.fixture
def cpu():
    return torch.device("cpu")

# The helpers live in ``tb_fixtures``; importable here too, for a session
# that puts this folder on the path and imports them from ``conftest``.
from tb_fixtures import tiny_config, tiny_traffic  # noqa: E402,F401
