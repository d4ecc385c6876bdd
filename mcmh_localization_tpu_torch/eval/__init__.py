from mcmh_localization_tpu_torch.eval.evaluator import (
    EvalResult,
    evaluate_run,
    save_results,
)

# the JAX package's eval exports
__all__ = ["EvalResult", "evaluate_run", "save_results"]
