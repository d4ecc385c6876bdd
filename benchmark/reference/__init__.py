"""The plain reference and the comparison that decides ``correct``."""
