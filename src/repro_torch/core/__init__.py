"""The paper's scheduling layer, ported: ``executor`` runs one shallow job per
cluster affiliation, one CUDA stream per affiliation on the card."""
