"""Sort-decode evaluation entry point:
`python -m multimodal_sequencing_tpu_torch.trainers.eval ...`."""
from ..train.cli import main_eval

if __name__ == "__main__":
    main_eval()
