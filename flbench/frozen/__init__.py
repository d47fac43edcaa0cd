"""The benchmark's yardstick: copies of the program's traffic and cost
arithmetic, frozen so that a change to the program cannot move them.
``flbench/tests/test_flbench_frozen.py`` holds each copy to the program's
current output."""
