"""The ensemble forward runner."""
