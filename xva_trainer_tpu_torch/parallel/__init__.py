"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``xva_trainer_tpu/parallel``): ``distributed`` sets the process group up,
``mesh`` lays the ranks out as ("data", "model"), ``tp`` splits the conv
FFNs over the model axis, and ``draws`` makes each rank's random draws the
one-process step's."""
