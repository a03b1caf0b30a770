"""The port's command-line programs (``simulate`` so far)."""
