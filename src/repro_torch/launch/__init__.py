"""Launchers: ``train``, the one-card training entry point."""
