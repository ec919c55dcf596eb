"""Distributed traditional ML (survey §Distributed classification /
clustering): boosting, SVM, k-means, fuzzy c-means + consensus.

The port of the JAX package's ``classic`` package.  Importing it does not
import torch; its modules do."""
