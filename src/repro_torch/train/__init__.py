"""Serving steps (``serve``); the training steps are ROADMAP Queue A item
14b's."""
