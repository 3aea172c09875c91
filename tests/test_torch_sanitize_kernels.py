"""``tools/torch_sanitize_kernels.py`` on the CPU: its case generator and
its reading of a compute-sanitizer log.

The kernels themselves run only on the card (the sanitize gate's CUDA
phases). Here the generator yields every case with the wrappers on CPU
tensors, where they take their plain versions, so each case must agree
with its plain version bitwise. ``refused_alone`` must call a log
``unsupported`` only when it holds the tool's refusal of the card and the
API failures that follow it: a device-side report, a case that ran, or a
log without the refusal is not a refusal.
"""

import importlib.util
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_sanitize_kernels", ROOT / "tools" / "torch_sanitize_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# compute-sanitizer 2025.2.1's memcheck of the program on a card it
# refuses (the host backtrace cut to three frames)
REFUSED = """\
========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported Devices" section of the sanitizer documentation
=========
========= Program hit cudaErrorUnknown (error 999) due to "unknown error" on CUDA API call to cudaMalloc.
=========     Saved host backtrace up to driver entry point at error
=========         Host Frame: c10::cuda::CUDACachingAllocator::Native::NativeCachingAllocator::allocate(unsigned long) [0x449cb] in libc10_cuda.so
=========         Host Frame: _inputs in torch_sanitize_kernels.py:88
=========         Host Frame: main in torch_sanitize_kernels.py:178
=========
Traceback (most recent call last):
  File "tools/torch_sanitize_kernels.py", line 88, in _inputs
    X = torch.from_numpy(sample[:n].copy()).to(device)
torch.AcceleratorError: CUDA error: unknown error

========= Target application returned an error
========= ERROR SUMMARY: 3 errors
"""

# racecheck on the same card: no API report, the program's failed exit
# counted as its one hazard
RACECHECK_REFUSED = """\
========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported Devices" section of the sanitizer documentation
=========
Traceback (most recent call last):
  File "tools/torch_sanitize_kernels.py", line 120, in _inputs
    X = torch.from_numpy(sample[:n].copy()).to(device)
torch.AcceleratorError: CUDA error: unknown error

========= Error: process didn't terminate successfully
=========     The application may have hit an error when dereferencing Unified Memory from the host. Please rerun the application under cuda-gdb or a host debugger to catch host side errors.
========= Target application returned an error
========= RACECHECK SUMMARY: 1 hazard displayed (1 error, 0 warnings)
"""

RACE_REPORT = """\
========= Error: Race reported between Write access at knn_topk_kernel+0x2b0
=========     and Read access at knn_topk_kernel+0x310 [8 hazards]
"""

MEMCHECK_REPORT = """\
========= Invalid __global__ read of size 4 bytes
=========     at knn_topk_kernel+0x1a0
=========     by thread (3,0,0) in block (0,0,0)
"""


@pytest.mark.parametrize("log, refused", [
    (REFUSED, True),
    (REFUSED + MEMCHECK_REPORT, False),
    (REFUSED.replace("Traceback", "[knn_topk] knn S 5 k 5, 1 rows: "
                     "bitwise equal, twice\nTraceback"), False),
    (REFUSED.replace("Device not supported", "Target ready"), False),
    ("========= COMPUTE-SANITIZER\n" + MEMCHECK_REPORT
     + "========= ERROR SUMMARY: 1 error\n", False),
    (RACECHECK_REFUSED, True),
    (RACECHECK_REFUSED.replace("=========\nTraceback",
                               "=========\n" + RACE_REPORT + "Traceback"),
     False),
], ids=["refusal", "refusal-and-report", "refusal-and-case-ran",
        "no-refusal", "report-only", "racecheck-refusal",
        "racecheck-refusal-and-race"])
def test_refused_alone_reads_only_a_bare_refusal_as_unsupported(
        log, refused):
    got = _tool().refused_alone(log)
    if refused:
        assert got is not None and got.startswith(
            "Error: Device not supported")
    else:
        assert got is None


def test_cases_on_the_cpu_agree_with_their_plain_versions():
    tool = _tool()
    sys.path.insert(0, str(ROOT))
    seen = {}
    for kernel, what, run, plain in tool._cases(torch.device("cpu")):
        first, want = run(), plain()
        assert tool._same(first, want), f"{kernel} {what}"
        seen[kernel] = seen.get(kernel, 0) + 1
    # rows 1, 7 and 777, finite and not: 6 inputs; two forests, three
    # corpora, one SVC (the launch shapes are forced only on a card)
    assert seen == {"forest_proba": 12, "knn_topk": 18, "rbf_decision": 6}
