"""Worker-count resolution (thread_limit.hpp:10-33, main.cpp:560-591).

The library never reads the environment itself; the CLI resolves
``--threads`` then ``LAC_THREADS`` and passes an explicit count (0 =
auto). On the device path the count caps host worker lanes (packing,
tokenizing, file I/O) — device parallelism is the array dimension.
"""


def parse_thread_limit(value) -> int:
    """Strict positive-integer parse; '' / None -> 0 (auto)."""
    if value is None or value == "":
        return 0
    if not all("0" <= c <= "9" for c in value):
        raise ValueError("LAC_THREADS must be a positive integer")
    parsed = int(value)
    if parsed == 0:
        raise ValueError("LAC_THREADS must be a positive integer")
    return parsed


def parse_threads_flag(flag: str):
    """Parse ``--threads=N``; returns N or None if the flag is not ours."""
    prefix = "--threads="
    if not flag.startswith(prefix):
        return None
    value = flag[len(prefix):]
    if not value or not all("0" <= c <= "9" for c in value):
        raise ValueError("--threads requires a positive integer")
    parsed = int(value)
    if parsed == 0:
        raise ValueError("--threads requires a positive integer")
    return parsed
