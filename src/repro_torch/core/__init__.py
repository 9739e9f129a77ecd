"""Round driver, strategies, aggregation operators and the engines."""
