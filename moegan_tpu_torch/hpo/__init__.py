from moegan_tpu_torch.hpo.search import SearchSpace, parse_metric_lines, run_hpo

__all__ = ["SearchSpace", "run_hpo", "parse_metric_lines"]
