"""Graph substrate: structures, generators, partitioners, algorithms."""
