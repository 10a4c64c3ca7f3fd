"""Test env: 4 virtual CPU devices (NOT 512 — that is dry-run-only; see
launch/dryrun.py) so the distributed DPMM tests exercise real cross-device
psums while smoke tests stay fast.

Also registers ``--update-goldens`` for the golden-chain fingerprint suite
(tests/test_golden_chains.py): regenerate tests/goldens/*.json instead of
comparing against them."""
import os

os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "")
     + " --xla_force_host_platform_device_count=4").strip())


def pytest_addoption(parser):
    parser.addoption(
        "--update-goldens", action="store_true", default=False,
        help="rewrite tests/goldens/*.json from this run's chains "
             "(commit the diff deliberately — it means chains changed)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's hand-written kernels); "
        "skipped where none is available")
