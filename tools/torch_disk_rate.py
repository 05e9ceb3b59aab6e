"""Write and read rates of the disk under the temporary directory: the
floor under a checkpoint's save and restore times (io/checkpoint.py
flushes each file to disk before its rename).

    python3 tools/torch_disk_rate.py [--gib 4] [--turns 2]

Each turn writes ``--gib`` GiB of zeros in 1 MiB blocks, flushes them to
disk (fsync), then reads the file back (a warm page cache, as a restore
right after a save finds it), and prints both rates.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--gib", type=int, default=4)
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args(argv)
    block = bytes(1 << 20)
    buf = bytearray(1 << 20)
    n = args.gib << 30
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "blob")
        for turn in range(1, args.turns + 1):
            t0 = time.perf_counter()
            with open(path, "wb") as f:
                for _ in range(args.gib << 10):
                    f.write(block)
                f.flush()
                os.fsync(f.fileno())
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            with open(path, "rb", buffering=0) as f:
                while f.readinto(buf):
                    pass
            read_s = time.perf_counter() - t0
            os.unlink(path)
            print(f"turn {turn}: {n} B written and fsync'd in {write_s:.3f} s = "
                  f"{n / write_s / 1e9:.3f} GB/s; read back (warm page cache) in {read_s:.3f} s "
                  f"= {n / read_s / 1e9:.3f} GB/s", flush=True)


if __name__ == "__main__":
    main()
