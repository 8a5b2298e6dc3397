"""Rollout engine and its configuration."""
