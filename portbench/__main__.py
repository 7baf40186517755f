import time

START = time.perf_counter()  # the process's start, before any heavy import: set-up is timed from here

if __name__ == "__main__":
    import sys

    from portbench.run import main

    sys.exit(main(start=START))
