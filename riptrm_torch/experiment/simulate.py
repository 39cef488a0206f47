"""CLI alias: ``python -m riptrm_torch.experiment.simulate``."""
from riptrm_torch.experiment.simulator import main

if __name__ == "__main__":
    main()
