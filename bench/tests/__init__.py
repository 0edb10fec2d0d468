"""CPU tests of the benchmark (``python -m pytest bench/tests``); the
tests marked ``cuda`` run on the card only."""
