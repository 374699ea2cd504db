import os
import sys

from .cli import main

if __name__ == "__main__":
    try:
        rc = main()
        sys.stdout.flush()
    except BrokenPipeError:
        # Downstream pager/`head` closed the pipe — the unix-conventional
        # exit, not a traceback. Dup devnull over stdout so the interpreter
        # shutdown flush doesn't raise again.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        rc = 141  # 128 + SIGPIPE
    raise SystemExit(rc)
