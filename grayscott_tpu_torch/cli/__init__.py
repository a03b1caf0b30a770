"""The port's command-line programs: ``simulate``, ``livesim`` and
``data-to-pics``."""
