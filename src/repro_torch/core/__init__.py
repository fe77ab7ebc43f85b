"""The scheduler core: graphs, cost models, partitioner, simulator, policies,
and the executor and serving loop that run them on torch devices."""
