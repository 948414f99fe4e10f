"""Configuration loading."""
