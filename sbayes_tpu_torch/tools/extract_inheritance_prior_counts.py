"""Name-parity wrapper: see sbayes_tpu_torch.tools.extract_prior_counts."""
from sbayes_tpu_torch.tools.extract_prior_counts import main_inheritance as main

if __name__ == "__main__":
    main()
