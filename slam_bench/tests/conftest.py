import sys
from pathlib import Path

# the repository root, so that `slam_bench` and the port import as packages
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
