"""Plain references: Tacotron 2 (NVIDIA/tacotron2 ``model.py``) and the
optimiser of the reference's ``train.py``, in torch operations alone. They
import nothing of the program and nothing of JAX."""
