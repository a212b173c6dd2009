"""Program analyses the passes use (``usedef``)."""
