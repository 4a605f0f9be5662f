"""Scripts of cmrtpu_torch, run as modules: the A/B tools, the quickstart
and analyze_results, the demos and the measurement scripts."""
