"""Entry points: ``launch.train`` (``run_training``, virtual-clock path)
and ``launch.quickstart``."""
