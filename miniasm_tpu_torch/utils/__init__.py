"""Timers, logging and the exact radix argsort."""
