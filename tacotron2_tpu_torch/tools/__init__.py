"""Tools of the port: the tone-corpus training demo, the quality gate and
the two vocoder trainers."""
