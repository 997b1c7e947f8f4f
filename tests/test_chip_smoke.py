"""chip_smoke.py off the card: it must refuse to report success without a
GPU, and --four must select only the four-card phase. Its four-card
comparison is rehearsed here on virtual CPU devices."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_no_gpu_exits_nonzero_without_ok_line():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_four_selects_only_its_phase():
    assert chip_smoke.phases_for(True) == ("device", "four")
    one = chip_smoke.phases_for(False)
    assert one[0] == "device" and "four" not in one
    assert {"oracle", "kernel", "main", "timing"} <= set(one)


def test_four_card_path_rehearsal_on_virtual_devices():
    """The --four comparisons on 4 of conftest's 8 CPU devices at a tiny
    size, with the kernel interpreted: pixel-sharded == one device, and
    the sample-axis psum == 4 sequential passes."""
    lines = chip_smoke.check_four_cards(4, w=32, h=16, passes=2,
                                        pallas_interpret=True)
    assert len(lines) == 3
    assert "on 4 devices" in lines[0]
    json.dumps(lines)
