"""Name-parity wrapper: see sbayes_tpu_torch.tools.align_clusters."""
from sbayes_tpu_torch.tools.align_clusters import cli_realign as main

if __name__ == "__main__":
    main()
