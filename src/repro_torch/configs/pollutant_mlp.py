"""The paper's network: softsign MLP 6 -> 40 -> 200 -> 1000 -> 2670
(2,882,150 fp32 parameters), predicting the pollutant concentration at 2670
points from 6 uncertain parameters."""

PAPER_SIZES = (6, 40, 200, 1000, 2670)
