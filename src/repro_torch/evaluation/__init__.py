"""The paper's own evaluation on the port: the Tables 1-3 proxies of
``benchmarks/table{1,2,3}_*.py``, run on the card by default."""
