"""Run one test function of tests/test_torch_gpu.py N times in one process
on the card, to see whether (and where) a test that fails now and then
fails: one JSON line for each failing run (the test file's lines in the
traceback, the message), then {"test", "runs", "failed"}.  It takes the
function's only argument as the ``cuda`` fixture gives it.

    python3 tests/loop_on_card.py test_server_batched_fp32_equals_alone_on_card 50
"""

import json
import os
import sys
import traceback

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]
import test_torch_gpu  # noqa: E402


def main() -> int:
    name, n = sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 50
    if not torch.cuda.is_available():
        print("loop_on_card: no CUDA card visible to torch", file=sys.stderr)
        return 1
    test, failed = getattr(test_torch_gpu, name), 0
    for i in range(n):
        try:
            test(torch.device("cuda"))
        except AssertionError as e:
            failed += 1
            where = [f"{os.path.basename(f.filename)}:{f.lineno} {f.line}" for f in traceback.extract_tb(e.__traceback__)
                     if f.filename.endswith("test_torch_gpu.py")]
            print(json.dumps({"run": i, "where": where, "msg": str(e)[:300]}), flush=True)
    print(json.dumps({"test": name, "runs": n, "failed": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
