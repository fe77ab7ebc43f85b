"""The plain reference the benchmark's output checks compare with."""
