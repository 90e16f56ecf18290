"""Priors and analysis updates."""
