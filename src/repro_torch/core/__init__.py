"""Agent-side mechanisms: blocks, pipeline shuffle, sync caching/skipping,
balancing lemmas and the vertex-program template."""
