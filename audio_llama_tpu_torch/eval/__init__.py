"""Accuracy measurement: logit KL between two trees and word error rate."""
